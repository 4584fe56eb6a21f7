"""Align each HaMeR MANO mesh to its Hunyuan HOI mesh; write
{id}_hamer_aligned_mano.ply.

Counterpart of followmyhold_tpu/alignment/mano.py, with the same ICP knobs as
``h2m``, skips and messages.

    python -m followmyhold_tpu_torch.alignment.mano --hamer_out_dir ... \\
        --hunyuan_mesh_dir ... --aligned_mano_dir ... [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os

from followmyhold_tpu_torch.alignment.h2m import ICP_KNOBS
from followmyhold_tpu_torch.alignment.mesh_align import align_meshes_impl
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device


def run(hamer_out_dir: str, hunyuan_mesh_dir: str, aligned_mano_dir: str,
        device: DeviceLike = "cuda") -> None:
    dev = resolve_device(device)
    meshes = sorted(glob.glob(os.path.join(hamer_out_dir, "*.obj")))
    if not meshes:
        print(f"No HaMeR meshes found in {hamer_out_dir}")
        return
    os.makedirs(aligned_mano_dir, exist_ok=True)

    for mesh_path in meshes:
        base = os.path.basename(mesh_path)
        image_id = base.split("_")[0]
        stem = os.path.splitext(base)[0]
        target = os.path.join(hunyuan_mesh_dir, f"{image_id}_hoi_mesh.ply")
        out_path = os.path.join(aligned_mano_dir, f"{stem}_aligned_mano.ply")
        if os.path.exists(out_path):
            print(f"{image_id} aligned mano exists, skipping")
            continue
        if not os.path.isfile(target):
            print(f"No Hunyuan mesh for {image_id}. Skipping.")
            continue
        align_meshes_impl(source_mesh_path=mesh_path, target_mesh_path=target,
                          transform_path=None, transformed_mesh_path=out_path, device=dev,
                          **ICP_KNOBS)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--hamer_out_dir", required=True)
    parser.add_argument("--hunyuan_mesh_dir", required=True)
    parser.add_argument("--aligned_mano_dir", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    run(args.hamer_out_dir, args.hunyuan_mesh_dir, args.aligned_mano_dir, device=args.device)


if __name__ == "__main__":
    main()
