"""Guidance losses, float32 with NaN guards.

Counterpart of followmyhold_tpu/ops/losses.py. All reductions run in float32;
where the original pipeline skips NaN terms with control flow, these mask with
``torch.where``.

The guidance losses take a batch of images (every input leads with B) and are
per-image means. Each returns its ``Mean`` unreduced; ``image_means`` reduces
any number of them at once, each image on its own, in one
``scatter_rows_add``: fixed point on the card, so an image's loss and its
gradient do not depend on which images share its batch, and one launch for all
of an iteration's sums.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional

import torch

from followmyhold_tpu_torch.ops.indexing import (
    image_rows,
    scatter_rows_add,
    take_image_rows,
)
from followmyhold_tpu_torch.ops.safe import safe_norm, safe_normalize


class Mean(NamedTuple):
    """A per-image mean not yet reduced: each image's sum(values * weights) /
    max(sum(weights), 1), or its mean of ``values`` where ``weights`` is None.
    values and weights [B, ...], of one shape."""

    values: torch.Tensor
    weights: Optional[torch.Tensor] = None


@functools.lru_cache(maxsize=64)
def _sum_rows(n_images: int, sizes: tuple, device: torch.device) -> torch.Tensor:
    """The output row of each entry of tensors [B, n_k] laid end to end, k
    after k: k * B + b; made once for each shape, never written to."""
    return torch.cat([image_rows(n_images, n, device) + k * n_images
                      for k, n in enumerate(sizes)])


def image_means(*means: Mean) -> List[torch.Tensor]:
    """Each ``Mean``'s value per image, [B] each, from one ``scatter_rows_add``
    over the entries of all of them."""
    B = means[0].values.shape[0]
    parts = []
    for m in means:
        v = m.values.float().reshape(B, -1)
        if m.weights is None:
            parts.append(v)
        else:
            w = m.weights.float().reshape(B, -1)
            parts += [v * w, w]
    sizes = tuple(p.shape[1] for p in parts)
    flat = torch.cat([p.reshape(-1) for p in parts])[:, None]
    sums = scatter_rows_add(len(parts) * B, _sum_rows(B, sizes, flat.device), flat)
    sums = sums.reshape(len(parts), B).unbind(0)
    out, k = [], 0
    for m in means:
        if m.weights is None:
            out.append(sums[k] / sizes[k])
            k += 1
        else:
            out.append(sums[k] / sums[k + 1].clamp(min=1.0))
            k += 2
    return out


def normal_alignment_loss(
    rendered_normals: torch.Tensor,
    gt_normals: torch.Tensor,
    valid_mask: Optional[torch.Tensor] = None,
) -> Mean:
    """Mean (1 - cos) between unit normals over valid pixels."""
    r = safe_normalize(rendered_normals.float())
    g = safe_normalize(gt_normals.float())
    return Mean(1.0 - torch.sum(r * g, dim=-1), valid_mask)


def masked_l1(pred: torch.Tensor, target: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> Mean:
    """L1; with a mask it is the mean over ALL pixels of |pred - target*mask|."""
    pred = pred.float()
    target = target.float()
    if mask is not None:
        target = target * mask.float()
    return Mean(torch.abs(pred - target))


def mse(pred: torch.Tensor, target: torch.Tensor) -> Mean:
    return Mean(torch.square(pred.float() - target.float()))


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor,
                         eps: float = 1e-7) -> Mean:
    """Binary cross entropy on probabilities (clamped logs)."""
    p = pred.float().clamp(eps, 1.0 - eps)
    t = target.float()
    return Mean(-(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)))


def honerf_intersection_loss(sdf_hand: torch.Tensor, sdf_obj: torch.Tensor) -> torch.Tensor:
    """(# grid points inside both hand and object) / 1000; not differentiable."""
    return torch.sum((sdf_obj < 0) & (sdf_hand < 0)).float() / 1000.0


def soft_intersection_loss(sdf_hand: torch.Tensor, sdf_obj: torch.Tensor) -> torch.Tensor:
    """Differentiable variant: mean(relu(-sdf_h) * relu(-sdf_o))."""
    loss = torch.mean(torch.relu(-sdf_hand.float()) * torch.relu(-sdf_obj.float()))
    return torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)


def attraction_loss(dists_sq_hand_to_obj: torch.Tensor, margin: float = 0.01,
                    mask: Optional[torch.Tensor] = None) -> Mean:
    """mean(clamp(d - margin, 0)) over hand verts; takes SQUARED distances."""
    return Mean((dists_sq_hand_to_obj.float() - margin).clamp(min=0.0), mask)


def mesh_edge_loss(verts: torch.Tensor, edges: torch.Tensor,
                   edge_mask: Optional[torch.Tensor] = None,
                   target_length: float = 0.0) -> Mean:
    """Mean squared edge length. verts [B,V,3], edges [B,E,2], each image's
    vertex indices into its own verts (padded edges point at vertex 0 and are
    masked out)."""
    a, b = take_image_rows(verts, edges).unbind(-2)
    length = safe_norm(a - b, dim=-1)
    return Mean(torch.square(length - target_length), edge_mask)


def verts_reg_loss(verts: torch.Tensor, mask: Optional[torch.Tensor] = None) -> Mean:
    """mean(v^2) over valid verts."""
    return Mean(torch.square(verts.float()).mean(dim=-1), mask)


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
