"""Rotation representations used on the guided sampler's path.

Counterpart of followmyhold_tpu/ops/rotations.py; only the quaternion to
matrix conversion is on this path (the pose parameters are raw wxyz
quaternions).
"""

from __future__ import annotations

import torch

from followmyhold_tpu_torch.ops.safe import safe_normalize


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion(s) [..., 4] -> rotation matrix [..., 3, 3].

    Normalizes first: guidance optimizes raw quaternions, so they drift off
    the unit sphere.
    """
    quat = safe_normalize(quat)
    w, x, y, z = quat.unbind(-1)
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, dim=-2)
