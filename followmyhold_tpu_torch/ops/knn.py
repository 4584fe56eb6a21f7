"""Nearest-neighbour queries as dense pairwise reductions.

Counterpart of followmyhold_tpu/ops/knn.py (the original pipeline used
pytorch3d's knn_points for the guidance attraction loss). The point sets on the
path are small (778 hand vertices against at most 32,768 object vertices), so
the pairwise squared distances are computed densely, in chunks of queries.
Every function also takes a batch of images: query [B,N,3], points [B,M,3],
masks [B,M], each image's queries against its own points.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from followmyhold_tpu_torch.ops.indexing import take_image_rows, take_rows

_BIG = torch.finfo(torch.float32).max


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N,3] x [M,3] -> [N,M] squared distances, by the direct (a-b)^2
    expansion: exact in float32 where |a|^2+|b|^2-2ab cancels for close
    points."""
    diff = a.float()[..., :, None, :] - b.float()[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def _masked(d: torch.Tensor, points_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if points_mask is None:
        return d
    return torch.where(points_mask[..., None, :].bool(), d, torch.full_like(d, _BIG))


def nn_sqdist(
    query: torch.Tensor,
    points: torch.Tensor,
    points_mask: Optional[torch.Tensor] = None,
    chunk: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each query point, the (squared distance, index) of its nearest
    point; ``points_mask`` excludes padded points. Chunked over queries.

    The search runs without autograd; the distance is then taken again from
    the query to its nearest point, so its gradient is elementwise (the
    search's would be a reduction over all points, whose split may follow the
    batch size)."""
    idxs = []
    with torch.no_grad():
        for q in query.split(chunk, dim=-2):
            idxs.append(_masked(pairwise_sqdist(q, points), points_mask).argmin(dim=-1))
    idx = torch.cat(idxs, dim=-1)
    if query.dim() == 3:
        nearest = take_image_rows(points, idx)
    else:
        nearest = take_rows(points, idx)
    diff = query.float() - nearest.float()
    d = torch.sum(diff * diff, dim=-1)
    if points_mask is not None:
        valid = (take_image_rows(points_mask[..., None], idx) if query.dim() == 3
                 else take_rows(points_mask[:, None], idx))[..., 0].bool()
        d = torch.where(valid, d, torch.full_like(d, _BIG))
    return d, idx


def knn(
    query: torch.Tensor,
    points: torch.Tensor,
    k: int,
    points_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest neighbours: (squared distances [N,k], indices [N,k]),
    nearest first."""
    d = _masked(pairwise_sqdist(query, points), points_mask)
    neg_d, idx = torch.topk(-d, k, dim=-1)
    return -neg_d, idx
