"""Rigid and similarity transforms over padded vertex buffers.

Counterpart of followmyhold_tpu/ops/transforms.py. Meshes are
(verts [V,3], vert_mask [V]); the mask keeps bbox centers right under padding.
"""

from __future__ import annotations

from typing import Optional

import torch

from followmyhold_tpu_torch.ops.precision import matmul_f32
from followmyhold_tpu_torch.ops.rotations import quaternion_to_matrix


def masked_bbox_center(verts: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(min+max)/2 over valid vertices."""
    if mask is None:
        return (verts.amin(dim=-2) + verts.amax(dim=-2)) / 2.0
    big = torch.finfo(verts.dtype).max
    m = mask[..., None].bool()
    lo = torch.where(m, verts, torch.full_like(verts, big)).amin(dim=-2)
    hi = torch.where(m, verts, torch.full_like(verts, -big)).amax(dim=-2)
    return (lo + hi) / 2.0


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 (or 3x4) transform: p' = p @ R^T + t."""
    return matmul_f32(points, T[:3, :3].T) + T[:3, 3]


def transform_around_center_w_scale(
    verts: torch.Tensor,
    T: torch.Tensor,
    scale: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """verts' = (scale*(v - c)) @ R^T + c + t, c = bbox center."""
    center = masked_bbox_center(verts, mask)
    return matmul_f32(scale * (verts - center), T[:3, :3].T) + center + T[:3, 3]


def rt_from_quat_trans(quat_wxyz: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """The 4x4 [R|t] the guidance loop assembles per step."""
    R = quaternion_to_matrix(quat_wxyz)
    top = torch.cat([R, trans.to(R.dtype)[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom], dim=0)
