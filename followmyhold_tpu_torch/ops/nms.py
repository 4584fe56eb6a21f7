"""Detection post-processing: greedy NMS and ROIAlign on the device.

Counterpart of followmyhold_tpu/ops/nms.py, which replaces the original
detector's C/CUDA extensions (nms.cu, ROIAlign_cuda.cu) by array programs.
Neither function reaches a Pallas kernel there, and here both are PyTorch
tensor programs.

``nms`` orders the boxes by a stable descending sort (ties keep index order,
as ``jnp.argsort(-scores)`` does) and builds the strictly-earlier suppression
matrix S[i, j] = (IoU(i, j) > t) & (j < i) once. The greedy mask is the one
fixed point of keep_i = not any_j(S[i, j] & keep_j): the greedy recursion
defines keep_i from the keep_j with j < i alone, so it has one solution, and
iterating from all-true settles entry i once the longest suppression chain
that ends at i has been walked. So it takes (longest chain + 1) steps, each a
boolean matrix-vector product on the device and one host sync to test for
the fixed point, where the reference's scan takes one step per box.

``roi_align`` samples every channel at once: ``sampling_ratio``^2 bilinear
taps a bin with the ``aligned=False`` grid (i + 0.5) * bin / s, each tap
outside the map counting 0 (``map_coordinates(order=1, mode="constant")``),
averaged per bin.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from followmyhold_tpu_torch.ops.image import box_iou


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: Optional[int] = None) -> torch.Tensor:
    """Greedy NMS over xyxy boxes [N, 4] with scores [N] -> keep mask [N]
    bool (True = kept): in score order, a box is dropped when its IoU with an
    earlier kept box exceeds ``iou_threshold``; then at most ``max_out`` of
    the kept boxes, the best first, stay kept."""
    n = boxes.shape[0]
    dev = boxes.device
    order = torch.sort(-scores, stable=True).indices
    sorted_boxes = boxes[order].float()
    iou = box_iou(sorted_boxes[:, None, :], sorted_boxes[None, :, :])
    idx = torch.arange(n, device=dev)
    suppress = (iou > iou_threshold) & (idx[None, :] < idx[:, None])
    del iou
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    while True:
        nxt = ~(suppress & keep[None, :]).any(dim=1)
        if torch.equal(nxt, keep):
            break
        keep = nxt
    if max_out is not None:
        rank = torch.cumsum(keep.to(torch.int32), 0) - 1
        keep = keep & (rank < max_out)
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    out[order] = keep
    return out


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              output_size: Tuple[int, int] = (7, 7), spatial_scale: float = 1.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign: features [H, W, C] and xyxy boxes [R, 4] -> [R, oh, ow, C]
    float32 (the mean of sampling_ratio^2 bilinear samples a bin, aligned=False)."""
    H, W, C = features.shape
    oh, ow = output_size
    s = sampling_ratio
    dev = features.device
    box = boxes.float() * spatial_scale
    x1, y1, x2, y2 = box.unbind(-1)
    roi_w = torch.clamp(x2 - x1, min=1.0)
    roi_h = torch.clamp(y2 - y1, min=1.0)
    bin_w = roi_w / ow
    bin_h = roi_h / oh
    iy = torch.arange(oh * s, dtype=torch.float32, device=dev)
    ix = torch.arange(ow * s, dtype=torch.float32, device=dev)
    ys = y1[:, None] + (iy[None] + 0.5) * bin_h[:, None] / s       # [R, oh*s]
    xs = x1[:, None] + (ix[None] + 0.5) * bin_w[:, None] / s       # [R, ow*s]

    flat = features.float().reshape(H * W, C)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    out = None
    for yi, wy in ((y0, 1.0 - wy1), (y0 + 1.0, wy1)):
        vy = (yi >= 0) & (yi < H)
        yc = yi.clamp(0, H - 1).long()
        for xi, wx in ((x0, 1.0 - wx1), (x0 + 1.0, wx1)):
            vx = (xi >= 0) & (xi < W)
            xc = xi.clamp(0, W - 1).long()
            idx = yc[:, :, None] * W + xc[:, None, :]                 # [R, oh*s, ow*s]
            tap = flat[idx.reshape(-1)].reshape(*idx.shape, C)
            valid = (vy[:, :, None] & vx[:, None, :])[..., None]
            weight = (wy[:, :, None] * wx[:, None, :])[..., None]
            term = weight * torch.where(valid, tap, torch.zeros((), device=dev))
            out = term if out is None else out + term
    R = boxes.shape[0]
    return out.reshape(R, oh, s, ow, s, C).mean(dim=(2, 4))
