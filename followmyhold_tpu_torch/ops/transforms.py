"""Rigid and similarity transforms over padded vertex buffers.

Counterpart of followmyhold_tpu/ops/transforms.py. Meshes are
(verts [V,3], vert_mask [V]); the mask keeps bbox centers right under padding.
Every function also takes a batch of images: verts [B,V,3], masks [B,V],
transforms [B,4,4], quaternions [B,4], translations [B,3] and scales [B]; one
mesh is transformed as a batch of one.

A batch is transformed so that each image's numbers do not depend on which
images share its batch, gradients included: each image's rotation,
translation, scale and center are gathered onto its points
(``ops/indexing.repeat_per_image``, whose gradient sums in fixed point on the
card) and the 3x3 products are elementwise, where a batched matrix product and
a broadcast's gradient could round apart by batch size there.
"""

from __future__ import annotations

from typing import Optional

import torch

from followmyhold_tpu_torch.ops.indexing import repeat_per_image
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


def _rotate(rel: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``rel @ R^T + t`` for a batch: R [B,n,9] and t [B,n,3] hold each
    image's rotation and translation on each of its points; elementwise 3x3
    products."""
    B, n = rel.shape[:2]
    return (rel.float()[..., None, :] * R.reshape(B, n, 3, 3)).sum(-1) + t


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 (or 3x4) transform: p' = p @ R^T + t."""
    if points.dim() == 2:
        return transform_points(points[None], T[None])[0]
    B, n = points.shape[:2]
    per_image = torch.cat([T[:, :3, :3].reshape(B, 9), T[:, :3, 3]], dim=1)
    return _rotate(points, *repeat_per_image(per_image.float(), n).split([9, 3], dim=-1))


def transform_around_center_w_scale(
    verts: torch.Tensor,
    T: torch.Tensor,
    scale: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """verts' = (scale*(v - c)) @ R^T + c + t, c = bbox center."""
    if verts.dim() == 2:
        return transform_around_center_w_scale(
            verts[None], T[None], scale, None if mask is None else mask[None])[0]
    center = masked_bbox_center(verts, mask)
    B, n = verts.shape[:2]
    s = torch.as_tensor(scale, dtype=verts.dtype, device=verts.device).reshape(B, 1)
    R, t, c, s = repeat_per_image(torch.cat([T[:, :3, :3].reshape(B, 9), T[:, :3, 3], center, s],
                                            dim=1).float(), n).split([9, 3, 3, 1], dim=-1)
    return _rotate(s * (verts - c), R, t) + c


def rt_from_quat_trans(quat_wxyz: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """The 4x4 [R|t] the guidance loop assembles per step."""
    R = quaternion_to_matrix(quat_wxyz)
    top = torch.cat([R, trans.to(R.dtype)[..., :, None]], dim=-1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(*top.shape[:-2], 1, 4)], dim=-2)
