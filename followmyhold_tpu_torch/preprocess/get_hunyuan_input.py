"""The HOI input stage (stage 2): per photo, detect, crop and segment, and
write what the later stages read.

Counterpart of followmyhold_tpu/preprocess/get_hunyuan_input.py, with the
same files and names:
  {original_img_dir}/{id}.png, {occ_img_dir}/{id}_masked_obj.png,
  {cropped_img_dir}/{id}_cropped_hoi_{is_right}.png,
  {cropped_img_wo_bckg_dir}/{id}_cropped_hoi_{is_right}.png,
  {mask_dir}/{id}_cropped_obj_mask.png, {id}_cropped_hand_mask.png and
  {id}_crop_transform.npy.
A photo whose crop exists (either hand) is skipped; a photo that fails is
reported with its traceback and the next one runs. The crop's warp and the
learned detectors (where their converted files exist) run on ``device``; the
heuristic detectors on the host.

    python -m followmyhold_tpu_torch.preprocess.get_hunyuan_input \\
        (--split_path <csv> | --image_path <image>) --occ_img_dir ... \\
        --cropped_img_dir ... --cropped_img_wo_bckg_dir ... --mask_dir ... \\
        --original_img_dir ... [--gemini_responses <csv>] [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import os
import traceback
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

from followmyhold_tpu_torch.preprocess.detectors import default_bundle
from followmyhold_tpu_torch.preprocess.gemini_objname import read_names
from followmyhold_tpu_torch.preprocess.segment_hoi import hoi_detector
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device


def _read_split(split_path: str) -> List[Tuple[str, str]]:
    """(img_id, img_path) of each row of a split CSV."""
    with open(split_path, "r", encoding="utf-8") as f:
        return [(row["img_id"], row["img_path"]) for row in csv.DictReader(f)]


def run(
    occ_img_dir: str,
    cropped_img_dir: str,
    cropped_img_wo_bckg_dir: str,
    mask_dir: str,
    original_img_dir: str,
    split_path: Optional[str] = None,
    image_path: Optional[str] = None,
    gemini_responses: Optional[str] = None,
    project_root: Optional[str] = None,   # CLI parity
    device: DeviceLike = "cuda",
) -> None:
    """Every photo of the split (or the one photo) through ``hoi_detector``,
    its files written under the five directories."""
    dev = resolve_device(device)
    for d in (occ_img_dir, cropped_img_dir, cropped_img_wo_bckg_dir, mask_dir,
              original_img_dir):
        os.makedirs(d, exist_ok=True)

    if split_path:
        items = _read_split(split_path)
    elif image_path:
        items = [(os.path.splitext(os.path.basename(image_path))[0], image_path)]
    else:
        raise ValueError("Provide split_path or image_path")

    names = read_names(gemini_responses)
    bundle = default_bundle(dev)

    for image_id, path in items:
        try:
            done = [os.path.join(cropped_img_dir, f"{image_id}_cropped_hoi_{r}.png")
                    for r in (0, 1)]
            if any(os.path.exists(p) for p in done):
                print(f"{image_id} exists, skipping")
                continue

            img = np.asarray(Image.open(path).convert("RGB"))
            out = hoi_detector(img, bundle, object_name=names.get(image_id), device=dev)
            rid = int(out["is_right"])

            Image.fromarray(img).save(os.path.join(original_img_dir, f"{image_id}.png"))
            Image.fromarray(out["occluded_obj"]).save(
                os.path.join(occ_img_dir, f"{image_id}_masked_obj.png"))
            Image.fromarray(out["cropped_hoi"]).save(
                os.path.join(cropped_img_dir, f"{image_id}_cropped_hoi_{rid}.png"))
            Image.fromarray(out["cropped_hoi_wo_bckg"]).save(
                os.path.join(cropped_img_wo_bckg_dir, f"{image_id}_cropped_hoi_{rid}.png"))
            Image.fromarray((out["obj_mask"] * 255).astype(np.uint8)).save(
                os.path.join(mask_dir, f"{image_id}_cropped_obj_mask.png"))
            Image.fromarray((out["hand_mask"] * 255).astype(np.uint8)).save(
                os.path.join(mask_dir, f"{image_id}_cropped_hand_mask.png"))
            np.save(os.path.join(mask_dir, f"{image_id}_crop_transform.npy"), out["transform"])
            print(f"Processed {image_id}")
        except Exception as e:      # one photo's failure: report it, run the next
            print(f"Error processing {image_id}: {e}")
            traceback.print_exception(type(e), e, e.__traceback__)


def main() -> None:
    parser = argparse.ArgumentParser(description="HOI input generation (stage 2)")
    parser.add_argument("--split_path", default=None)
    parser.add_argument("--image_path", default=None)
    parser.add_argument("--occ_img_dir", required=True)
    parser.add_argument("--cropped_img_dir", required=True)
    parser.add_argument("--cropped_img_wo_bckg_dir", required=True)
    parser.add_argument("--mask_dir", required=True)
    parser.add_argument("--original_img_dir", required=True)
    parser.add_argument("--gemini_responses", default=None)
    parser.add_argument("--project_root", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    run(args.occ_img_dir, args.cropped_img_dir, args.cropped_img_wo_bckg_dir, args.mask_dir,
        args.original_img_dir, args.split_path, args.image_path, args.gemini_responses,
        args.project_root, device=args.device)


if __name__ == "__main__":
    main()
