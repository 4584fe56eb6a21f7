"""The chamfer-parity evaluation over a benchmark split.

Counterpart of followmyhold_tpu/eval/run.py. It reads a split
(``img_id,img_path`` rows, as the reference's test_splits/*.csv) and reports
the chamfer distance and the F-scores at 5 and 10 mm of the exported object
meshes ({id}_obj.ply) against reference meshes, in the reference's report
JSON. Two modes:

- ``--pred_dir`` with ``--ref_dir``: compare existing {id}_obj.ply pairs;
- ``--base_dir``: first run the port's whole pipeline (``main.run_pipeline``
  on ``--device``) for every split row whose prediction is missing, one env
  file and workspace a row, then compare as above.

    python -m followmyhold_tpu_torch.eval.run --split_path split.csv \\
        --pred_dir out/guidance --ref_dir ref_exports --report report.json [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device


def read_split(split_path: str) -> List[Dict[str, str]]:
    with open(split_path, "r", encoding="utf-8") as f:
        return list(csv.DictReader(f))


def _mesh_pair_metrics(pred_path: str, ref_path: str, samples: int,
                       device: torch.device) -> Dict[str, float]:
    from followmyhold_tpu_torch.eval.metrics import chamfer_distance, f_score
    from followmyhold_tpu_torch.ops.icp import sample_surface
    from followmyhold_tpu_torch.utils.mesh_io import load_mesh

    pred, ref = load_mesh(pred_path), load_mesh(ref_path)
    pa = torch.from_numpy(sample_surface(np.asarray(pred.vertices), np.asarray(pred.faces),
                                         samples, seed=0)).to(device)
    pb = torch.from_numpy(sample_surface(np.asarray(ref.vertices), np.asarray(ref.faces),
                                         samples, seed=1)).to(device)
    return {"chamfer": float(chamfer_distance(pa, pb)),
            "f@5mm": float(f_score(pa, pb, threshold=0.005)),
            "f@10mm": float(f_score(pa, pb, threshold=0.01))}


def _run_missing(rows, pred_dir: str, base_dir: str, image_root: Optional[str],
                 device: torch.device) -> None:
    """The whole pipeline for each row without a prediction; a failing row
    is reported with its traceback and the next one runs."""
    from followmyhold_tpu_torch.configs.pipeline import load_config
    from followmyhold_tpu_torch.main import run_pipeline

    for row in rows:
        img_id = row["img_id"]
        if os.path.exists(os.path.join(pred_dir, f"{img_id}_obj.ply")):
            continue
        img_path = row["img_path"]
        if image_root:
            img_path = os.path.join(image_root, img_path)
        if not os.path.exists(img_path):
            print(f"missing input image {img_path}; skipping {img_id}")
            continue
        cfg_file = os.path.join(base_dir, f"eval_{img_id}.env")
        with open(cfg_file, "w", encoding="utf-8") as f:
            f.write(f"PROJECT_ROOT={os.getcwd()}\n"
                    f"BASE_DIR={os.path.join(base_dir, img_id)}\n"
                    f"IMAGE_PATH={img_path}\nRUN_INPAINT=1\n")
        try:
            run_pipeline(load_config(cfg_file), device=device)
        except Exception as e:  # one row's failure; the next row runs
            print(f"pipeline failed for {img_id}: {e}")
            traceback.print_exception(type(e), e, e.__traceback__)


def evaluate(
    split_path: str,
    pred_dir: str,
    ref_dir: Optional[str] = None,
    base_dir: Optional[str] = None,
    image_root: Optional[str] = None,
    samples: int = 10000,
    max_rows: Optional[int] = None,
    report_path: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> Dict:
    """The report {"summary": ..., "per_image": ...} of the split's rows
    (the first ``max_rows``), written to ``report_path`` where given."""
    dev = resolve_device(device)
    rows = read_split(split_path)
    if max_rows:
        rows = rows[:max_rows]
    if base_dir is not None:
        _run_missing(rows, pred_dir, base_dir, image_root, dev)

    per_image = {}
    missing_pred = missing_ref = 0
    for row in rows:
        img_id = row["img_id"]
        pred = os.path.join(pred_dir, f"{img_id}_obj.ply")
        if not os.path.exists(pred):
            missing_pred += 1
            continue
        if ref_dir is None:
            per_image[img_id] = {"exported": True}
            continue
        ref = os.path.join(ref_dir, f"{img_id}_obj.ply")
        if not os.path.exists(ref):
            missing_ref += 1
            continue
        try:
            per_image[img_id] = _mesh_pair_metrics(pred, ref, samples, dev)
        except Exception as e:  # a degenerate mesh is reported in its row
            per_image[img_id] = {"error": str(e)}

    scored = [m for m in per_image.values() if "chamfer" in m]
    summary = {"split": os.path.basename(split_path), "rows": len(rows),
               "evaluated": len(scored), "missing_pred": missing_pred,
               "missing_ref": missing_ref}
    if scored:
        for key in ("chamfer", "f@5mm", "f@10mm"):
            summary[f"mean_{key}"] = float(np.mean([m[key] for m in scored]))
            summary[f"median_{key}"] = float(np.median([m[key] for m in scored]))

    result = {"summary": summary, "per_image": per_image}
    print(json.dumps(summary, indent=2))
    if report_path:
        with open(report_path, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=2)
        print(f"report -> {report_path}")
    return result


def main() -> None:
    parser = argparse.ArgumentParser(description="Chamfer-parity evaluation")
    parser.add_argument("--split_path", required=True)
    parser.add_argument("--pred_dir", required=True)
    parser.add_argument("--ref_dir", default=None,
                        help="reference meshes ({id}_obj.ply) to compare against")
    parser.add_argument("--base_dir", default=None,
                        help="run the pipeline for missing predictions here")
    parser.add_argument("--image_root", default=None)
    parser.add_argument("--samples", type=int, default=10000)
    parser.add_argument("--max_rows", type=int, default=None)
    parser.add_argument("--report", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    evaluate(args.split_path, args.pred_dir, args.ref_dir, args.base_dir, args.image_root,
             args.samples, args.max_rows, args.report, device=args.device)


if __name__ == "__main__":
    main()
