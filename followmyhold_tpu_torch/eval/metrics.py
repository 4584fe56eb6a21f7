"""Evaluation metrics on tensors, on the inputs' device.

Counterpart of followmyhold_tpu/eval/metrics.py:

- depth metrics as MoGe's evaluation kit computes them: rel = mean(|d - gt| /
  gt), delta1 = mean(max(d / gt, gt / d) < 1.25), optionally after the least-
  squares scale alignment (the closed form of MoGe's ``align_depth_scale``);
- the chamfer distance (the mean of both nearest-neighbour means, Euclidean)
  and the F-score at a distance threshold, over point sets, through
  ``ops/knn.nn_sqdist``; ``chamfer_between_meshes`` samples both surfaces on
  the host with the reference's draws (``ops/icp.sample_surface``) first.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from followmyhold_tpu_torch.ops.knn import nn_sqdist
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device


def align_depth_scale(pred: torch.Tensor, gt: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scale s minimising ||s pred - gt||^2 over the valid pixels."""
    w = torch.ones_like(pred) if mask is None else mask.to(pred.dtype)
    num = torch.sum(w * pred * gt)
    den = torch.clamp(torch.sum(w * pred * pred), min=1e-12)
    return num / den


def _valid(pred: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.ones_like(pred, dtype=torch.bool) if mask is None else mask.bool()


def rel_depth(pred: torch.Tensor, gt: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    w = _valid(pred, mask)
    rel = (pred - gt).abs() / torch.clamp(gt, min=1e-12)
    return torch.where(w, rel, torch.zeros_like(rel)).sum() / torch.clamp(w.sum(), min=1)


def delta1_depth(pred: torch.Tensor, gt: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 threshold: float = 1.25) -> torch.Tensor:
    w = _valid(pred, mask)
    ratio = torch.maximum(pred / torch.clamp(gt, min=1e-12), gt / torch.clamp(pred, min=1e-12))
    ok = (ratio < threshold) & w
    return ok.sum() / torch.clamp(w.sum(), min=1)


def scale_aligned_depth_metrics(pred: torch.Tensor, gt: torch.Tensor,
                                mask: Optional[torch.Tensor] = None):
    """-> (rel, delta1) after the least-squares scale alignment."""
    s = align_depth_scale(pred, gt, mask)
    return rel_depth(s * pred, gt, mask), delta1_depth(s * pred, gt, mask)


def chamfer_distance(a: torch.Tensor, b: torch.Tensor,
                     a_mask: Optional[torch.Tensor] = None,
                     b_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric chamfer distance of [N,3] and [M,3] point sets: the mean of
    the two nearest-neighbour means of Euclidean distances (masked points
    neither query nor answer)."""
    d_ab, _ = nn_sqdist(a, b, b_mask)
    d_ba, _ = nn_sqdist(b, a, a_mask)

    def masked_mean(d, m):
        dist = torch.sqrt(torch.clamp(d, min=0))
        if m is None:
            return dist.mean()
        w = m.float()
        return torch.sum(dist * w) / torch.clamp(w.sum(), min=1)

    return (masked_mean(d_ab, a_mask) + masked_mean(d_ba, b_mask)) / 2.0


def f_score(pred: torch.Tensor, gt: torch.Tensor, threshold: float = 0.01) -> torch.Tensor:
    """The F-score at a distance threshold: the harmonic mean of the shares
    of predicted points near the truth and of true points near the
    prediction."""
    d_pg, _ = nn_sqdist(pred, gt)
    d_gp, _ = nn_sqdist(gt, pred)
    precision = (torch.sqrt(d_pg) < threshold).float().mean()
    recall = (torch.sqrt(d_gp) < threshold).float().mean()
    return 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)


def chamfer_between_meshes(verts_a: np.ndarray, faces_a: np.ndarray,
                           verts_b: np.ndarray, faces_b: np.ndarray,
                           samples: int = 10000, seed: int = 0,
                           device: DeviceLike = "cuda") -> float:
    """Both surfaces sampled on the host (seeds ``seed`` and ``seed + 1``),
    their chamfer distance on ``device``."""
    from followmyhold_tpu_torch.ops.icp import sample_surface

    dev = resolve_device(device)
    pa = sample_surface(verts_a, faces_a, samples, seed=seed)
    pb = sample_surface(verts_b, faces_b, samples, seed=seed + 1)
    return float(chamfer_distance(torch.from_numpy(pa).to(dev), torch.from_numpy(pb).to(dev)))
