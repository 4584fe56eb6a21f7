"""Align each Hunyuan HOI mesh to its MoGe mesh; write {id}_hoi_mesh.npy.

Counterpart of followmyhold_tpu/alignment/h2m.py, with the same ICP knobs
(coarse 50 iterations at 1k/5k samples, fine 100 at 5k/10k, 20 % outliers,
scale in [0.7, 3.0]), skips and messages.

    python -m followmyhold_tpu_torch.alignment.h2m --hunyuan_mesh_dir ... \\
        --moge_out_dir ... --h2m_rt_dir ... [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os

from followmyhold_tpu_torch.alignment.mesh_align import align_meshes_impl
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device

# the reference's knobs of both alignments
ICP_KNOBS = dict(
    fixed_scale=False, outliers=0.2, test_rotations=False, test_reflections=False,
    on_surface=False, iterations_coarse=50, count_source_coarse=1000,
    count_target_coarse=5000, iterations_fine=100, count_source_fine=5000,
    count_target_fine=10000, min_scale=0.7, max_scale=3.0, plot=False)


def run(hunyuan_mesh_dir: str, moge_out_dir: str, h2m_rt_dir: str,
        device: DeviceLike = "cuda") -> None:
    dev = resolve_device(device)
    meshes = sorted(glob.glob(os.path.join(hunyuan_mesh_dir, "*.ply")))
    if not meshes:
        print(f"No Hunyuan HOI meshes found in {hunyuan_mesh_dir}")
        return
    os.makedirs(h2m_rt_dir, exist_ok=True)

    for mesh_path in meshes:
        base = os.path.basename(mesh_path)
        image_id = base.split("_")[0]
        stem = os.path.splitext(base)[0]
        if os.path.exists(os.path.join(h2m_rt_dir, f"{stem}.npy")):
            print(f"{image_id} transform exists, skipping")
            continue
        moge_dir = os.path.join(moge_out_dir, f"{image_id}_cropped_hoi")
        target = next((os.path.join(moge_dir, name) for name in ("mesh.ply", "pointcloud.ply")
                       if os.path.isfile(os.path.join(moge_dir, name))), None)
        if target is None:
            print(f"No MoGe mesh found for {image_id} in {moge_dir}. Skipping.")
            continue
        align_meshes_impl(source_mesh_path=mesh_path, target_mesh_path=target,
                          transform_path=os.path.join(h2m_rt_dir, stem),
                          transformed_mesh_path=None, device=dev, **ICP_KNOBS)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--hunyuan_mesh_dir", required=True)
    parser.add_argument("--moge_out_dir", required=True)
    parser.add_argument("--h2m_rt_dir", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    run(args.hunyuan_mesh_dir, args.moge_out_dir, args.h2m_rt_dir, device=args.device)


if __name__ == "__main__":
    main()
