"""The two-phase ICP mesh alignment.

Counterpart of followmyhold_tpu/alignment/mesh_align.py: the source mesh is
sampled on its surface (or taken as its vertices when it has no faces),
moved by the centroid and bounding-box-scale init, then aligned in a coarse
phase (50 iterations, 1k source / 5k target samples) and a fine phase (100
iterations, 5k / 10k), with 20 % outliers and the scale in [0.7, 3.0] by
default; optional restarts over the axis-aligned rotations and reflections
in the coarse phase. The ICP runs on ``device``; the sampling on the host,
with the reference's numpy draws.

    python -m followmyhold_tpu_torch.alignment.mesh_align SOURCE TARGET \\
        [-tp TRANSFORM.npy] [-tmp ALIGNED.ply] [--device cuda]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from followmyhold_tpu_torch.ops.icp import (
    axis_aligned_restarts,
    compute_init_transform,
    icp,
    sample_surface,
)
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device
from followmyhold_tpu_torch.utils.mesh_io import load_mesh, save_mesh


def _sample(mesh, count: int, seed: int) -> np.ndarray:
    if mesh.num_faces == 0:  # a point cloud: its vertices
        return mesh.vertices
    return sample_surface(mesh.vertices, mesh.faces, count, seed=seed)


def _apply(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ T[:3, :3].T + T[:3, 3]


def align_meshes_impl(
    source_mesh_path: str,
    target_mesh_path: str,
    transform_path: Optional[str] = None,
    transformed_mesh_path: Optional[str] = None,
    fixed_scale: bool = False,
    outliers: float = 0.2,
    test_rotations: bool = False,
    test_reflections: bool = False,
    on_surface: bool = False,  # accepted for parity; the nearest target sample is used
    iterations_coarse: int = 50,
    count_source_coarse: int = 1000,
    count_target_coarse: int = 5000,
    iterations_fine: int = 100,
    count_source_fine: int = 5000,
    count_target_fine: int = 10000,
    min_scale: float = 0.7,
    max_scale: float = 3.0,
    plot: bool = False,  # accepted, ignored (no viewer)
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Align the source mesh to the target mesh -> the 4x4 float32 transform;
    saved to ``transform_path`` (.npy) and the moved source mesh to
    ``transformed_mesh_path`` where given."""
    dev = resolve_device(device)
    start = time.time()
    source = load_mesh(source_mesh_path)
    target = load_mesh(target_mesh_path)

    src_pts = _sample(source, max(count_source_coarse, count_source_fine), seed)
    tgt_pts_coarse = _sample(target, count_target_coarse, seed + 1)
    tgt_pts_fine = _sample(target, count_target_fine, seed + 2)
    init_T = compute_init_transform(source.vertices, target.vertices, fixed_scale)

    cubes = None
    if test_rotations or test_reflections:
        cubes = torch.from_numpy(axis_aligned_restarts(
            include_identity=True, rotations=test_rotations, reflections=test_reflections))

    def points(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    res_coarse = icp(points(_apply(init_T, src_pts[:count_source_coarse])),
                     points(tgt_pts_coarse), n_iter=iterations_coarse, init_transforms=cubes,
                     outliers=outliers, fixed_scale=fixed_scale, min_scale=min_scale,
                     max_scale=max_scale)
    T_coarse = res_coarse.transform.cpu().numpy()

    res_fine = icp(points(_apply(T_coarse @ init_T, src_pts[:count_source_fine])),
                   points(tgt_pts_fine), n_iter=iterations_fine, outliers=outliers,
                   fixed_scale=fixed_scale, min_scale=min_scale, max_scale=max_scale)
    T_fine = res_fine.transform.cpu().numpy()

    final_T = (T_fine @ T_coarse @ init_T).astype(np.float32)
    if transform_path is not None:
        np.save(transform_path, final_T)
    if transformed_mesh_path is not None:
        save_mesh(transformed_mesh_path, _apply(final_T, source.vertices), source.faces)
    print(f"Elapsed time: {time.time() - start:.2f} seconds "
          f"(cost {float(res_fine.cost):.5f})")
    return final_T


def main() -> None:
    parser = argparse.ArgumentParser(description="ICP mesh alignment")
    parser.add_argument("source_mesh_path")
    parser.add_argument("target_mesh_path")
    parser.add_argument("-tp", "--transform_path", default=None)
    parser.add_argument("-tmp", "--transformed_mesh_path", default=None)
    parser.add_argument("-fs", "--fixed_scale", action="store_true")
    parser.add_argument("-o", "--outliers", type=float, default=0.2)
    parser.add_argument("-trot", "--test_rotations", action="store_true")
    parser.add_argument("-tref", "--test_reflections", action="store_true")
    parser.add_argument("-ir", "--iterations_coarse", type=int, default=50)
    parser.add_argument("-if", "--iterations_fine", type=int, default=100)
    parser.add_argument("-mis", "--min_scale", type=float, default=0.7)
    parser.add_argument("-mas", "--max_scale", type=float, default=3.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    align_meshes_impl(
        args.source_mesh_path, args.target_mesh_path, args.transform_path,
        args.transformed_mesh_path, args.fixed_scale, args.outliers,
        args.test_rotations, args.test_reflections, False,
        args.iterations_coarse, 1000, 5000, args.iterations_fine, 5000, 10000,
        args.min_scale, args.max_scale, False, device=args.device)


if __name__ == "__main__":
    main()
