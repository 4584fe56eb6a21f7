"""The MoGe stage (stage 4): point map, metric depth, normals, field of view
and scene mesh of every HOI crop.

Counterpart of followmyhold_tpu/geometry/moge.py, with the same inputs,
files and skips. Per crop it writes into {output_dir}/{stem}/, the stem cut
after its "hoi" ({id}_cropped_hoi_1.png -> {id}_cropped_hoi/): depth.npy,
points.npy, mask.png, normal.png, fov.json (fov_x and fov_y in degrees,
rounded to 0.01), depth.exr where cv2 writes EXR, and mesh.ply and
pointcloud.ply in GL convention (vertices * [1, -1, -1]) from the valid
pixels off the depth edges. An image whose fov.json and mesh.ply exist is
skipped. The model loads the converted checkpoint where its file exists and
carries seeded random weights where it does not (``_build_model``);
``FOHO_TPU_PROFILE=tiny`` picks the reference's
tiny configuration (``configs.profiles.moge_config``).

    python -m followmyhold_tpu_torch.geometry.moge --input <crops> --output <dir> \\
        [--resolution_level 9] [--threshold 0.04] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

import numpy as np
import torch
from PIL import Image

from followmyhold_tpu_torch.configs.profiles import moge_config
from followmyhold_tpu_torch.models.moge import MoGe, MoGeConfig, moge_infer
from followmyhold_tpu_torch.ops.image_mesh import depth_edge, image_mesh
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device
from followmyhold_tpu_torch.utils.mesh_io import write_ply
from followmyhold_tpu_torch.utils.params import init_random_, load_or_init


def _build_model(cfg: MoGeConfig, seed: int = 0, device: DeviceLike = "cuda") -> MoGe:
    """MoGe on ``device`` in eval mode, without gradients to the weights:
    the converted checkpoint ``moge`` where its file exists, else seeded
    random weights with the metric-scale readout at zero as the reference
    initialises it (a random one would put exp of a random number on every
    depth)."""
    def init(model: MoGe) -> None:
        init_random_(model, seed)
        with torch.no_grad():
            model.scale_out.weight.zero_()

    model = load_or_init("moge", MoGe(cfg, device=resolve_device(device)), init)
    return model.eval().requires_grad_(False)


def _write_depth_exr(path: str, depth: np.ndarray) -> None:
    """depth.exr, where this cv2 is built with EXR (as in the reference, no
    file otherwise)."""
    try:
        import cv2
    except ImportError:
        return
    try:
        cv2.imwrite(path, depth, [cv2.IMWRITE_EXR_TYPE, cv2.IMWRITE_EXR_TYPE_FLOAT])
    except cv2.error:
        pass


def run(
    input_dir: str,
    output_dir: str,
    resolution_level: int = 9,
    threshold: float = 0.04,
    project_root: Optional[str] = None,   # CLI parity
    models: Optional[MoGe] = None,
    device: DeviceLike = "cuda",
) -> None:
    """Every crop of ``input_dir`` through MoGe. ``models`` is a built
    ``MoGe`` on ``device`` (default: ``_build_model(moge_config())``)."""
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    model = models if models is not None else _build_model(moge_config(), device=dev)

    images = sorted(glob.glob(os.path.join(input_dir, "*.png"))
                    + glob.glob(os.path.join(input_dir, "*.jpg")))
    if not images:
        print(f"No images found in {input_dir}")
        return

    for img_path in images:
        stem = os.path.splitext(os.path.basename(img_path))[0]
        if "hoi" in stem:
            stem = stem.split("hoi")[0] + "hoi"
        save_dir = os.path.join(output_dir, stem)
        fov_path = os.path.join(save_dir, "fov.json")
        mesh_path = os.path.join(save_dir, "mesh.ply")
        if os.path.exists(fov_path) and os.path.exists(mesh_path):
            print(f"{stem} exists, skipping")
            continue
        os.makedirs(save_dir, exist_ok=True)

        image = np.asarray(Image.open(img_path).convert("RGB"), np.float32) / 255.0
        out = moge_infer(model, torch.from_numpy(image)[None].to(dev),
                         resolution_level=resolution_level)
        points = out.points[0].cpu().numpy()
        depth = out.depth[0].cpu().numpy()
        mask = out.mask[0].cpu().numpy()
        normal = out.normal[0].cpu().numpy() if out.normal is not None else None

        np.save(os.path.join(save_dir, "depth.npy"), depth)
        np.save(os.path.join(save_dir, "points.npy"), points)
        Image.fromarray((mask * 255).astype(np.uint8)).save(os.path.join(save_dir, "mask.png"))
        if normal is not None:
            vis = ((normal * 0.5 + 0.5) * 255).clip(0, 255).astype(np.uint8)
            Image.fromarray(vis).save(os.path.join(save_dir, "normal.png"))
        _write_depth_exr(os.path.join(save_dir, "depth.exr"), depth)
        with open(fov_path, "w", encoding="utf-8") as f:
            json.dump({"fov_x": round(float(out.fov_x_deg[0]), 2),
                       "fov_y": round(float(out.fov_y_deg[0]), 2)}, f)

        # the scene mesh in GL convention, off the depth edges
        mask_clean = mask & ~depth_edge(depth, rtol=threshold)
        verts, faces, _ = image_mesh(points, mask_clean)
        verts_gl = verts * np.array([1, -1, -1], np.float32)
        write_ply(mesh_path, verts_gl, faces)
        write_ply(os.path.join(save_dir, "pointcloud.ply"), verts_gl, None)
        print(f"Processed {stem}")


def main() -> None:
    parser = argparse.ArgumentParser(description="MoGe point map, depth, FoV and scene mesh")
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--project_root", default=None)
    parser.add_argument("--resolution_level", type=int, default=9)
    parser.add_argument("--threshold", type=float, default=0.04)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    run(args.input, args.output, args.resolution_level, args.threshold, args.project_root,
        device=args.device)


if __name__ == "__main__":
    main()
