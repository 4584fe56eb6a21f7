"""Image resampling and box helpers: the affine patch crop, resizes with the
semantics of ``jax.image.resize`` (cubic, linear, nearest), the ImageNet
normalisation, box IoU and the square box of the HOI crop.

Counterpart of followmyhold_tpu/ops/image.py. The patch crop (HaMeR's
ViTDetDataset crop) maps a source box onto the output patch by the similarity
``gen_trans_from_patch`` solves in closed form, and samples the image through
the inverse map bilinearly, as ``jax.scipy.ndimage.map_coordinates(order=1,
mode="constant")`` does: each of the four taps outside the image counts as 0,
and the taps are summed in the reference's order.

The conditioner resizes its normalised crop (512^2 on the main path) to the
encoder's 518^2 as the reference does, through ``jax.image.resize``: a Keys
cubic kernel with a = -0.5, sample positions at half-pixel centres, each
output's weights renormalised to sum to one (so the taps beyond the border
are dropped, not clamped), and antialiasing: when downsampling, the kernel
widens by the inverse scale. ``torch.nn.functional.interpolate(mode="bicubic")``
differs on every one of these points (a = -0.75, clamped taps, no widening),
so the resize here is two explicit separable weight matrices, computed in
float32 as the reference computes them. MoGe's linear resize is the same
construction with a triangle kernel: it upsamples the crop to the encoder's
grid (512 -> 840) and downsamples every head's output (960 -> 512), where the
widened triangle is not ``interpolate(mode="bilinear")``. Its nearest resize
samples source floor((i + 0.5) * in / out), torch's ``"nearest-exact"``, not
``"nearest"`` (which takes floor(i * in / out)).
"""

from __future__ import annotations

from typing import Sequence, Tuple

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


def _triangle(x: np.ndarray) -> np.ndarray:
    """The linear resize's kernel, max(0, 1 - |x|), in float32."""
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x)).astype(np.float32)


def resize_weights(in_size: int, out_size: int, kernel) -> np.ndarray:
    """[in_size, out_size] float32 weights of ``jax.image.resize`` with
    ``kernel`` (the Keys cubic or the triangle): output j = sum_i x[i] * W[i, j]."""
    inv_scale = 1.0 / (out_size / in_size)   # a Python float there too, rounded once
    kernel_scale = np.float32(max(inv_scale, 1.0))
    inv_scale = np.float32(inv_scale)
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale
              - np.float32(0.0) * inv_scale - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = kernel(x.astype(np.float32))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def _resize_hw(x: torch.Tensor, height: int, width: int, kernel) -> torch.Tensor:
    """[B, H, W, C] -> [B, height, width, C] in x's dtype, the weights cast
    to it as ``jax.image.resize`` casts them. An axis whose size does not
    change is left as it is, as there."""
    B, H, W, C = x.shape
    if H != height:
        wy = torch.from_numpy(resize_weights(H, height, kernel)).to(x.device, x.dtype)
        x = torch.einsum("bhwc,hk->bkwc", x, wy)
    if W != width:
        wx = torch.from_numpy(resize_weights(W, width, kernel)).to(x.device, x.dtype)
        x = torch.einsum("bhwc,wk->bhkc", x, wx)
    return x


def resize_cubic(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, height, width, C], float32, as
    ``jax.image.resize(image, (B, height, width, C), "cubic")``."""
    return _resize_hw(image.float(), height, width, _keys_cubic)


def resize_linear(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, H, W, C] floating -> [B, height, width, C] in its dtype, as
    ``jax.image.resize(image, (B, height, width, C), "linear")`` (antialiased)."""
    return _resize_hw(image, height, width, _triangle)


def resize_bilinear(image: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """[H,W,C] or [H,W] -> float32 [*out_hw(, C)], as ``jax.image.resize(image,
    shape, "bilinear")`` (the linear resize above: "bilinear" is its name for
    "linear")."""
    x = image.float()
    flat = x[None] if x.dim() == 3 else x[None, ..., None]
    out = resize_linear(flat, out_hw[0], out_hw[1])[0]
    return out if x.dim() == 3 else out[..., 0]


def normalize_imagenet(image01: torch.Tensor) -> torch.Tensor:
    """[..., 3] in [0, 1] -> ImageNet-normalised, in the image's dtype."""
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=image01.dtype, device=image01.device)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=image01.dtype, device=image01.device)
    return (image01 - mean) / std


def box_iou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """IoU of xyxy boxes, broadcasting [..., 4] x [..., 4]; 0 where the union
    is empty."""
    x1 = torch.maximum(box1[..., 0], box2[..., 0])
    y1 = torch.maximum(box1[..., 1], box2[..., 1])
    x2 = torch.minimum(box1[..., 2], box2[..., 2])
    y2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    a1 = (box1[..., 2] - box1[..., 0]) * (box1[..., 3] - box1[..., 1])
    a2 = (box2[..., 2] - box2[..., 0]) * (box2[..., 3] - box2[..., 1])
    union = a1 + a2 - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, torch.ones_like(union)),
                       torch.zeros_like(union))


def process_bbox(bbox_xywh: Sequence[float], factor: float = 1.25) -> list:
    """The square box of side max(w, h) * ``factor`` about the box's centre,
    as [x, y, w, h] floats."""
    x, y, w, h = (float(v) for v in bbox_xywh)
    c_x, c_y = x + w / 2.0, y + h / 2.0
    w = h = max(w, h) * factor
    return [c_x - w / 2.0, c_y - h / 2.0, w, h]


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """The source index of each output of the nearest resize,
    floor((i + 0.5) * in / out) in float32, as ``jax.image.resize`` takes it."""
    offsets = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(in_size)
               / np.float32(out_size))
    return np.floor(offsets.astype(np.float32)).astype(np.int64)


def resize_nearest(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, shape, "nearest")``: every axis whose size
    changes is sampled at ``nearest_indices``."""
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in != n_out:
            idx = torch.from_numpy(nearest_indices(n_in, n_out)).to(x.device)
            x = x.index_select(d, idx)
    return x


def gen_trans_from_patch(
    c_x: float, c_y: float,
    src_width: float, src_height: float,
    dst_width: float, dst_height: float,
    scale: float = 1.0, rot_deg: float = 0.0,
) -> np.ndarray:
    """The 2x3 affine that maps the source patch (centre, size, scale,
    rotation) onto the destination image, in float64 and returned as
    float32, as the reference solves it."""
    rot = np.pi * rot_deg / 180.0
    sn, cs = np.sin(rot), np.cos(rot)
    src_w, src_h = src_width * scale, src_height * scale
    right = np.array([cs * src_w * 0.5, sn * src_w * 0.5], np.float64)
    down = np.array([-sn * src_h * 0.5, cs * src_h * 0.5], np.float64)
    src_center = np.array([c_x, c_y], np.float64)
    dst_center = np.array([dst_width * 0.5, dst_height * 0.5], np.float64)
    src_mat = np.stack([right, down], axis=1)
    dst_mat = np.stack([np.array([dst_width * 0.5, 0.0]), np.array([0.0, dst_height * 0.5])],
                       axis=1)
    lin = dst_mat @ np.linalg.inv(src_mat)
    trans = np.zeros((2, 3), np.float32)
    trans[:, :2] = lin
    trans[:, 2] = dst_center - lin @ src_center
    return trans


def _sample_bilinear(image: torch.Tensor, src_y: torch.Tensor,
                     src_x: torch.Tensor) -> torch.Tensor:
    """image [H,W,C] at float coordinates [h,w] -> [h,w,C]; taps outside the
    image are 0."""
    H, W = image.shape[:2]
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy1, wx1 = src_y - y0, src_x - x0
    ys = ((y0.long(), 1 - wy1), (y0.long() + 1, wy1))
    xs = ((x0.long(), 1 - wx1), (x0.long() + 1, wx1))
    out = None
    for yi, wy in ys:
        for xi, wx in xs:
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            tap = image[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
            term = (wy * wx)[..., None] * torch.where(valid[..., None], tap,
                                                      torch.zeros_like(tap))
            out = term if out is None else out + term
    return out


def warp_affine(image: torch.Tensor, trans: np.ndarray, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Apply a 2x3 forward (source -> destination) affine to [H,W] or [H,W,C]
    by inverse bilinear sampling -> float32 [out_h, out_w(, C)]."""
    H, W = out_hw
    dev = image.device
    A = torch.from_numpy(np.concatenate([np.asarray(trans, np.float32),
                                         np.array([[0.0, 0.0, 1.0]], np.float32)]))
    a_inv = torch.linalg.inv(A).to(dev)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    src = a_inv @ torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
    img = image.float()
    flat = img[..., None] if img.dim() == 2 else img
    out = _sample_bilinear(flat, src[1].reshape(H, W), src[0].reshape(H, W))
    return out[..., 0] if img.dim() == 2 else out


def generate_patch_image(
    image: torch.Tensor,
    bbox_xywh: Sequence[float],
    out_hw: Tuple[int, int],
    do_flip: bool = False,
    scale: float = 1.0,
    rot_deg: float = 0.0,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Crop the affine patch of ``bbox_xywh`` from image [H,W,C] into out_hw;
    ``do_flip`` mirrors the image first (HaMeR's left hands). -> (patch, the
    3x3 transform)."""
    x, y, w, h = (float(v) for v in bbox_xywh)
    c_x, c_y = x + 0.5 * w, y + 0.5 * h
    if do_flip:
        image = image.flip(1)
        c_x = image.shape[1] - c_x - 1
    trans = gen_trans_from_patch(c_x, c_y, w, h, out_hw[1], out_hw[0], scale, rot_deg)
    patch = warp_affine(image, trans, out_hw)
    T = np.zeros((3, 3), np.float32)
    T[:2] = trans
    T[2, 2] = 1.0
    return patch, T
