"""Guidance losses, float32 with NaN guards.

Counterpart of followmyhold_tpu/ops/losses.py. All reductions run in float32;
where the original pipeline skips NaN terms with control flow, these mask with
``torch.where``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from followmyhold_tpu_torch.ops.indexing import take_rows
from followmyhold_tpu_torch.ops.safe import safe_norm, safe_normalize


def _masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return values.mean()
    w = mask.float()
    return torch.sum(values * w) / torch.sum(w).clamp(min=1.0)


def normal_alignment_loss(
    rendered_normals: torch.Tensor,
    gt_normals: torch.Tensor,
    valid_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean (1 - cos) between unit normals over valid pixels."""
    r = safe_normalize(rendered_normals.float())
    g = safe_normalize(gt_normals.float())
    return _masked_mean(1.0 - torch.sum(r * g, dim=-1), valid_mask)


def masked_l1(pred: torch.Tensor, target: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1; with a mask it is the mean over ALL pixels of |pred - target*mask|."""
    pred = pred.float()
    target = target.float()
    if mask is not None:
        target = target * mask.float()
    return torch.abs(pred - target).mean()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.square(pred.float() - target.float()).mean()


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor,
                         eps: float = 1e-7) -> torch.Tensor:
    """Binary cross entropy on probabilities (clamped logs)."""
    p = pred.float().clamp(eps, 1.0 - eps)
    t = target.float()
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)).mean()


def honerf_intersection_loss(sdf_hand: torch.Tensor, sdf_obj: torch.Tensor) -> torch.Tensor:
    """(# grid points inside both hand and object) / 1000; not differentiable."""
    return torch.sum((sdf_obj < 0) & (sdf_hand < 0)).float() / 1000.0


def soft_intersection_loss(sdf_hand: torch.Tensor, sdf_obj: torch.Tensor) -> torch.Tensor:
    """Differentiable variant: mean(relu(-sdf_h) * relu(-sdf_o))."""
    loss = torch.mean(torch.relu(-sdf_hand.float()) * torch.relu(-sdf_obj.float()))
    return torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)


def attraction_loss(dists_sq_hand_to_obj: torch.Tensor, margin: float = 0.01,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean(clamp(d - margin, 0)) over hand verts; takes SQUARED distances."""
    attract = (dists_sq_hand_to_obj.float() - margin).clamp(min=0.0)
    return _masked_mean(attract, mask)


def mesh_edge_loss(verts: torch.Tensor, edges: torch.Tensor,
                   edge_mask: Optional[torch.Tensor] = None,
                   target_length: float = 0.0) -> torch.Tensor:
    """Mean squared edge length. edges: [E, 2] vertex indices (padded edges
    point at vertex 0 and are masked out)."""
    length = safe_norm(take_rows(verts, edges[:, 0]) - take_rows(verts, edges[:, 1]), dim=-1)
    return _masked_mean(torch.square(length - target_length), edge_mask)


def verts_reg_loss(verts: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean(v^2) over valid verts."""
    return _masked_mean(torch.square(verts.float()).mean(dim=-1), mask)


def combine_losses_fp32(loss_terms: Dict[str, torch.Tensor],
                        weights: Dict[str, float]) -> torch.Tensor:
    """Weighted float32 sum; NaN terms contribute zero."""
    total = None
    for name, value in loss_terms.items():
        v = value.float()
        v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
        term = weights.get(name, 1.0) * v
        total = term if total is None else total + term
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return total
