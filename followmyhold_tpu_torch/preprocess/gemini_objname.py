"""The object-naming stage (stage 1).

Counterpart of followmyhold_tpu/preprocess/gemini_objname.py, with the same
CSV: one (image_id, image_path, name) row appended per image, an image
already in the CSV skipped. The name comes from the Gemini API where
GEMINI_API_KEY is set and its client package is installed (the model and
prompt of the original pipeline); otherwise from the split CSV's object
column, else "object" (the name only prompts the segmenter).

    python -m followmyhold_tpu_torch.preprocess.gemini_objname --out_csv <csv> \\
        (--split_path <csv> | --image_path <image>)
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Dict, List, Optional, Tuple

PROMPT = "What is the person holding in the image? Answer with the object name only."
MODEL = "gemini-2.5-flash-lite"


def _read_split(split_path: str) -> List[Tuple[str, str, Optional[str]]]:
    """(img_id, img_path, object name or None) of each row of a split CSV."""
    rows = []
    with open(split_path, "r", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            rows.append((row["img_id"], row["img_path"], row.get("object") or row.get("obj_name")))
    return rows


def read_names(path: Optional[str]) -> Dict[str, str]:
    """image_id -> object name, from a CSV this stage wrote (empty without one)."""
    names: Dict[str, str] = {}
    if path and os.path.exists(path):
        with open(path, "r", encoding="utf-8") as f:
            for row in csv.reader(f):
                if len(row) >= 3:
                    names[row[0]] = row[2]
    return names


def _query_gemini(image_path: str) -> Optional[str]:
    """The object's name from Gemini, or None without an API key or when the
    call fails (reported)."""
    api_key = os.environ.get("GEMINI_API_KEY")
    if not api_key:
        return None
    try:
        import google.generativeai as genai
        from PIL import Image

        genai.configure(api_key=api_key)
        resp = genai.GenerativeModel(MODEL).generate_content([PROMPT, Image.open(image_path)])
        return resp.text.strip()
    except Exception as e:      # any failure of the optional service: fall back
        print(f"Gemini query failed ({e}); falling back")
        return None


def run(out_csv: str, split_path: Optional[str] = None,
        image_path: Optional[str] = None) -> None:
    """Append a name for every image of the split (or the one image) not yet
    in ``out_csv``."""
    if split_path:
        items = _read_split(split_path)
    elif image_path:
        stem = os.path.splitext(os.path.basename(image_path))[0]
        items = [(stem, image_path, None)]
    else:
        raise ValueError("Provide split_path or image_path")

    done = set()
    if os.path.exists(out_csv):
        with open(out_csv, "r", encoding="utf-8") as f:
            done = {row[0] for row in csv.reader(f) if row}

    os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
    with open(out_csv, "a", encoding="utf-8", newline="") as f:
        writer = csv.writer(f)
        for image_id, path, obj in items:
            if image_id in done:
                continue
            name = _query_gemini(path) or obj or "object"
            writer.writerow([image_id, path, name])
            print(f"{image_id}: {name}")


def main() -> None:
    parser = argparse.ArgumentParser(description="Object naming (stage 1)")
    parser.add_argument("--out_csv", required=True)
    parser.add_argument("--split_path", default=None)
    parser.add_argument("--image_path", default=None)
    args = parser.parse_args()
    run(args.out_csv, args.split_path, args.image_path)


if __name__ == "__main__":
    main()
