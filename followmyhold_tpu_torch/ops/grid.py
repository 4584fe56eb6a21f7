"""Dense SDF-query grids."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device


def generate_dense_grid_points(
    bbox_min,
    bbox_max,
    octree_resolution: int,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, Tuple[int, int, int], torch.Tensor]:
    """Regular (R+1)^3 grid over the bbox, 'ij' indexing, flattened [N, 3].

    Returns (xyz [N,3], grid_size, length). The static linspace is made with
    numpy (resolution is a Python int), so the points are bit-identical to the
    reference's.
    """
    dev = resolve_device(device)
    bbox_min = np.asarray(bbox_min, dtype=np.float32)
    bbox_max = np.asarray(bbox_max, dtype=np.float32)
    n = int(octree_resolution) + 1
    axes = [np.linspace(bbox_min[d], bbox_max[d], n, dtype=np.float32) for d in range(3)]
    xs, ys, zs = np.meshgrid(*axes, indexing="ij")
    xyz = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3)
    return (torch.from_numpy(xyz).to(dev), (n, n, n),
            torch.from_numpy(bbox_max - bbox_min).to(dev))
