"""Image resampling with the semantics of ``jax.image.resize(..., "cubic")``.

The conditioner resizes its normalised crop (512^2 on the main path) to the
encoder's 518^2 as the reference does, through ``jax.image.resize``: a Keys
cubic kernel with a = -0.5, sample positions at half-pixel centres, each
output's weights renormalised to sum to one (so the taps beyond the border
are dropped, not clamped), and antialiasing: when downsampling, the kernel
widens by the inverse scale. ``torch.nn.functional.interpolate(mode="bicubic")``
differs on every one of these points (a = -0.75, clamped taps, no widening),
so the resize here is two explicit separable weight matrices, computed in
float32 as the reference computes them.
"""

from __future__ import annotations

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5, in the reference's
    operation order (float32 in, float32 out)."""
    x = np.abs(x)
    one, two = np.float32(1.0), np.float32(2.0)
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + one
    out = np.where(x >= one, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + two, out)
    return np.where(x >= two, np.float32(0.0), out).astype(np.float32)


def cubic_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights: output j = sum_i x[i] * W[i, j]."""
    inv_scale = 1.0 / (out_size / in_size)   # a Python float there too, rounded once
    kernel_scale = np.float32(max(inv_scale, 1.0))
    inv_scale = np.float32(inv_scale)
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale
              - np.float32(0.0) * inv_scale - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x.astype(np.float32))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def resize_cubic(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, height, width, C], float32, as
    ``jax.image.resize(image, (B, height, width, C), "cubic")``. An axis whose
    size does not change is left as it is, as there."""
    x = image.float()
    B, H, W, C = x.shape
    if H != height:
        wy = torch.from_numpy(cubic_resize_weights(H, height)).to(x.device)
        x = torch.einsum("bhwc,hk->bkwc", x, wy)
    if W != width:
        wx = torch.from_numpy(cubic_resize_weights(W, width)).to(x.device)
        x = torch.einsum("bhwc,wk->bhkc", x, wx)
    return x
