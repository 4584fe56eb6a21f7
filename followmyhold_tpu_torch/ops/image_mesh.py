"""Point map -> mesh, on the host (numpy): the MoGe stage's triangulation.

The port's copy of followmyhold_tpu/ops/image_mesh.py (``depth_edge`` and
``image_mesh``, which stand in for utils3d's in the original MoGe stage): the
valid pixels of the grid are connected into triangles, and the faces across
a depth discontinuity are dropped by masking its pixels first. On the same
inputs both give the reference's vertices and faces bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def depth_edge(depth: np.ndarray, rtol: float = 0.04, kernel: int = 3) -> np.ndarray:
    """True where the depth's relative variation over a (kernel x kernel)
    window, (max - min) / max, exceeds ``rtol``: a depth discontinuity."""
    H, W = depth.shape
    pad = kernel // 2
    d = np.pad(depth, pad, mode="edge")
    dmin = np.full_like(depth, np.inf)
    dmax = np.full_like(depth, -np.inf)
    for dy in range(kernel):
        for dx in range(kernel):
            w = d[dy:dy + H, dx:dx + W]
            dmin = np.minimum(dmin, w)
            dmax = np.maximum(dmax, w)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = (dmax - dmin) / np.maximum(dmax, 1e-12)
    return rel > rtol


def image_mesh(
    points: np.ndarray,                  # [H,W,3]
    mask: Optional[np.ndarray] = None,   # [H,W] bool
    attrs: Optional[np.ndarray] = None,  # [H,W,C] per-vertex attributes
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Triangulate the pixel grid over the valid pixels -> (verts float32,
    faces int32, attrs). Each quad of four valid pixels gives two triangles,
    split along its 00-11 diagonal (all first triangles, then all second
    ones); the vertices are the valid pixels in row-major order."""
    H, W = points.shape[:2]
    if mask is None:
        mask = np.ones((H, W), bool)
    idx = np.full((H, W), -1, np.int64)
    ys, xs = np.nonzero(mask)
    idx[ys, xs] = np.arange(len(ys))
    verts = points[ys, xs].astype(np.float32)
    vattrs = attrs[ys, xs] if attrs is not None else None

    quad = mask[:-1, :-1] & mask[:-1, 1:] & mask[1:, :-1] & mask[1:, 1:]
    qy, qx = np.nonzero(quad)
    i00 = idx[qy, qx]
    i01 = idx[qy, qx + 1]
    i10 = idx[qy + 1, qx]
    i11 = idx[qy + 1, qx + 1]
    f1 = np.stack([i00, i11, i01], axis=-1)
    f2 = np.stack([i00, i10, i11], axis=-1)
    faces = np.concatenate([f1, f2], axis=0).astype(np.int32)
    return verts, faces, vattrs
