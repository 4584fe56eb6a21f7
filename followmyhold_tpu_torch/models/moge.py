"""MoGe-2, the monocular geometry model, in PyTorch.

Counterpart of followmyhold_tpu/models/moge.py (after MoGe's v2 model: a
DINOv2-L encoder, 1x1 projections of four of its layers summed, a five-level
convolutional neck whose levels 1-4 start from normalised view-plane UV
maps, three convolutional heads (points, mask, normal) and an MLP metric-scale
head on the cls token; the head outputs resized to the input's size).

Layout: images enter and outputs leave channels-last, as in the reference;
inside, feature maps are NCHW for torch's convolutions. Module and parameter
names follow the Flax modules, so ``utils.params.flax_to_torch`` loads a Flax
tree (its HWIO kernels onto OIHW ``Conv2d`` weights). Precision as in the
reference: bf16 convolutions and matmuls; float32 GroupNorms (epsilon 1e-6,
Flax's), head output convolutions, scale MLP and resizes. The encoder's
attention goes through ``ops.attention.multi_head_attention``: at the default
resolution level a 512^2 crop becomes a 60x60 patch grid, 3,601 tokens with
the cls token, so on the card the flash-attention kernel runs at
[1, 16, 3601, 64].

``recover_focal_shift`` fits the focal length and the z shift that make the
affine point map a perspective one, on a 64x64 nearest-sampled subset: a grid
of 64 candidate shifts, then 30 golden-section iterations, batched over the
images on the device with no host synchronisation in the loop (the same
objective and the same closed-form focal as the reference's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from followmyhold_tpu_torch.models.vit import DINOV2_VIT_L, ViT, ViTConfig
from followmyhold_tpu_torch.ops.image import resize_linear, resize_nearest

# Flax's GroupNorm epsilon (torch's default is 1e-5)
_GN_EPS = 1e-6
_IMAGE_MEAN = (0.485, 0.456, 0.406)
_IMAGE_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class MoGeConfig:
    encoder: ViTConfig = DINOV2_VIT_L
    intermediate_layers: Tuple[int, ...] = (5, 11, 17, 23)
    dim_proj: int = 512                                    # the encoder's 1x1 projections
    neck_dims: Tuple[int, ...] = (512, 256, 128, 64, 32)   # per level, stride 1 .. 1/16
    head_dims: Tuple[int, ...] = (512, 256, 128, 64, 32)
    num_res_blocks: int = 2
    resampler: str = "pixel_shuffle"   # 'pixel_shuffle' | 'bilinear' | 'nearest'
    res_block_hidden_mult: int = 1
    scale_head_dims: Tuple[int, ...] = (1024, 512, 128, 1)
    use_normal_head: bool = True
    remap_output: str = "linear"       # 'linear' | 'sinh' | 'exp' | 'sinh_exp'
    num_tokens_range: Tuple[int, int] = (1200, 3600)
    dtype: torch.dtype = torch.bfloat16


class MoGeOutput(NamedTuple):
    points: torch.Tensor            # [B,H,W,3] camera space (OpenCV, z forward)
    depth: torch.Tensor             # [B,H,W]
    normal: Optional[torch.Tensor]  # [B,H,W,3]
    mask: torch.Tensor              # [B,H,W] bool
    intrinsics: torch.Tensor        # [B,3,3] normalised
    metric_scale: torch.Tensor      # [B]
    fov_x_deg: torch.Tensor         # [B]
    fov_y_deg: torch.Tensor         # [B]


def normalized_view_plane_uv(height: int, width: int, aspect_ratio: Optional[float] = None,
                             device=None) -> torch.Tensor:
    """[H,W,2] float32 UV spanning +-(w, h) / diagonal at the pixel centres."""
    if aspect_ratio is None:
        aspect_ratio = width / height
    span_x = aspect_ratio / (1 + aspect_ratio ** 2) ** 0.5
    span_y = 1 / (1 + aspect_ratio ** 2) ** 0.5
    u = np.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width, width)
    v = np.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height, height)
    uu, vv = np.meshgrid(u.astype(np.float32), v.astype(np.float32), indexing="xy")
    return torch.from_numpy(np.stack([uu, vv], axis=-1)).to(device)


class ReplConv3(nn.Module):
    """3x3 convolution over replicate padding."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.to(self.conv.weight.dtype), (1, 1, 1, 1), mode="replicate")
        return self.conv(x)


def _conv1x1(in_channels: int, out_channels: int, dtype: torch.dtype, device=None) -> nn.Conv2d:
    return nn.Conv2d(in_channels, out_channels, 1, dtype=dtype, device=device)


def _group_norm_f32(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """``norm`` in float32 with Flax's epsilon. The moments are one reduction
    over each (image, group) flattened: ``F.group_norm`` takes one block per
    (image, group), so the GroupNorm(1) of a 960x960x32 map ran in one block
    (583 of a 641-ms forward on one H100, tools/profile_moge.py)."""
    B, C = x.shape[:2]
    grouped = x.float().reshape(B, norm.num_groups, -1)
    var, mean = torch.var_mean(grouped, dim=-1, correction=0, keepdim=True)
    y = ((grouped - mean) * torch.rsqrt(var + _GN_EPS)).reshape(x.shape)
    affine = (1, C) + (1,) * (x.dim() - 2)
    return y * norm.weight.reshape(affine) + norm.bias.reshape(affine)


class ResidualConvBlock(nn.Module):
    """GroupNorm(1) -> relu -> conv3 -> GroupNorm(hidden / 32) -> relu ->
    conv3, plus the input; both norms in float32. (The reference's 1x1 skip
    projection for differing widths has no caller: a stack's blocks keep
    their level's width.)"""

    def __init__(self, channels: int, hidden_channels: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.in_norm = nn.GroupNorm(1, channels, device=device)
        self.conv1 = ReplConv3(channels, hidden_channels, dtype, device)
        self.hidden_norm = nn.GroupNorm(max(hidden_channels // 32, 1), hidden_channels,
                                        device=device)
        self.conv2 = ReplConv3(hidden_channels, channels, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(_group_norm_f32(x, self.in_norm)).to(self.dtype)
        h = self.conv1(h)
        h = F.relu(_group_norm_f32(h, self.hidden_norm)).to(self.dtype)
        return self.conv2(h) + x


class Resampler(nn.Module):
    """x2 upsampling between neck levels: a conv to 4x the width and a pixel
    shuffle (``nn.PixelShuffle`` on NCHW is the reference's channel map), then
    a conv; or a linear / nearest resize, then a conv."""

    def __init__(self, in_channels: int, out_channels: int, kind: str, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.kind = kind
        if kind == "pixel_shuffle":
            self.conv0 = ReplConv3(in_channels, out_channels * 4, dtype, device)
            self.conv1 = ReplConv3(out_channels, out_channels, dtype, device)
        elif kind in ("bilinear", "nearest"):
            self.conv0 = ReplConv3(in_channels, out_channels, dtype, device)
        else:
            raise ValueError(f"Unsupported resampler: {kind}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "pixel_shuffle":
            return self.conv1(F.pixel_shuffle(self.conv0(x), 2))
        B, C, H, W = x.shape
        if self.kind == "bilinear":
            h = resize_linear(x.permute(0, 2, 3, 1), 2 * H, 2 * W).permute(0, 3, 1, 2)
        else:
            h = resize_nearest(x, (B, C, 2 * H, 2 * W))
        return self.conv0(h)


class ConvStack(nn.Module):
    """Per level: the level's input through a 1x1 conv, added to the running
    features; the residual blocks; a 1x1 output conv (float32) when
    ``out_dim`` is given; then the resampler to the next level. ->
    each level's output."""

    def __init__(self, in_dims: Sequence[int], level_dims: Sequence[int],
                 out_dim: Optional[int], num_res_blocks: int, dtype: torch.dtype,
                 resampler: str = "pixel_shuffle", hidden_mult: int = 1, device=None):
        super().__init__()
        self.level_dims, self.out_dim, self.dtype = tuple(level_dims), out_dim, dtype
        self.num_res_blocks = num_res_blocks
        for lvl, dim in enumerate(level_dims):
            if lvl < len(in_dims):
                self.add_module(f"in{lvl}", _conv1x1(in_dims[lvl], dim, dtype, device))
            for b in range(num_res_blocks):
                self.add_module(f"res{lvl}_{b}", ResidualConvBlock(
                    dim, dim * hidden_mult, dtype, device))
            if out_dim is not None:
                self.add_module(f"out{lvl}", _conv1x1(dim, out_dim, torch.float32, device))
            if lvl < len(level_dims) - 1:
                self.add_module(f"up{lvl}", Resampler(dim, level_dims[lvl + 1], resampler,
                                                      dtype, device))

    def forward(self, inputs: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
        outs, x = [], None
        for lvl in range(len(self.level_dims)):
            inp = inputs[lvl] if lvl < len(inputs) else None
            if inp is not None:
                inp = getattr(self, f"in{lvl}")(inp.to(self.dtype))
                x = inp if x is None else x + inp
            for b in range(self.num_res_blocks):
                x = getattr(self, f"res{lvl}_{b}")(x)
            outs.append(getattr(self, f"out{lvl}")(x.float()) if self.out_dim is not None
                        else x)
            if lvl < len(self.level_dims) - 1:
                x = getattr(self, f"up{lvl}")(x)
        return outs


def _remap_points(points: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "linear":
        return points
    if kind == "sinh":
        return torch.sinh(points)
    if kind == "exp":
        z = torch.exp(points[..., 2:])
        return torch.cat([points[..., :2] * z, z], dim=-1)
    if kind == "sinh_exp":
        return torch.cat([torch.sinh(points[..., :2]), torch.exp(points[..., 2:])], dim=-1)
    raise ValueError(f"Invalid remap output type: {kind}")


def base_grid(num_tokens: int, height: int, width: int) -> Tuple[int, int]:
    """The encoder's patch grid for ``num_tokens`` at the image's aspect."""
    aspect = width / height
    return int((num_tokens / aspect) ** 0.5), int((num_tokens * aspect) ** 0.5)


class MoGe(nn.Module):
    def __init__(self, cfg: MoGeConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.backbone = ViT(c.encoder, device)
        for i in range(len(c.intermediate_layers)):
            self.add_module(f"proj{i}", _conv1x1(c.encoder.embed_dim, c.dim_proj, c.dtype, device))
        n = len(c.neck_dims)
        neck_in = (c.dim_proj + 2,) + (2,) * (n - 1)

        def stack(in_dims, dims, out_dim):
            return ConvStack(in_dims, dims, out_dim, c.num_res_blocks, c.dtype, c.resampler,
                             c.res_block_hidden_mult, device)

        self.neck = stack(neck_in, c.neck_dims, None)
        self.points_head = stack(c.neck_dims, c.head_dims, 3)
        self.mask_head = stack(c.neck_dims, c.head_dims, 1)
        if c.use_normal_head:
            self.normal_head = stack(c.neck_dims, c.head_dims, 3)
        dims = (c.encoder.embed_dim,) + tuple(c.scale_head_dims)
        for i in range(len(c.scale_head_dims) - 1):
            self.add_module(f"scale{i}", nn.Linear(dims[i], dims[i + 1], device=device))
        self.scale_out = nn.Linear(dims[-2], dims[-1], device=device)

    def forward(self, image: torch.Tensor, num_tokens: int) -> Dict[str, torch.Tensor]:
        """image [B,H,W,3] in [0, 1] -> the raw head outputs at the input's
        size: points [B,H,W,3], mask [B,H,W] (probabilities), normal
        [B,H,W,3] (unit) or None, metric_scale [B]."""
        c = self.cfg
        B, H, W, _ = image.shape
        aspect = W / H
        base_h, base_w = base_grid(num_tokens, H, W)
        p = c.encoder.patch_size
        img14 = resize_linear(image.float(), base_h * p, base_w * p)
        mean = torch.tensor(_IMAGE_MEAN, device=image.device)
        std = torch.tensor(_IMAGE_STD, device=image.device)
        inter, _, cls_token = self.backbone((img14 - mean) / std,
                                            out_layers=list(c.intermediate_layers))
        feat = None
        for i, tok in enumerate(inter):
            fmap = tok.reshape(B, base_h, base_w, -1).permute(0, 3, 1, 2).to(c.dtype)
            proj = getattr(self, f"proj{i}")(fmap)
            feat = proj if feat is None else feat + proj

        levels = []
        for lvl in range(len(c.neck_dims)):
            h_l, w_l = base_h * 2 ** lvl, base_w * 2 ** lvl
            uv = normalized_view_plane_uv(h_l, w_l, aspect, image.device)
            uv = uv.permute(2, 0, 1)[None].expand(B, -1, -1, -1).to(c.dtype)
            levels.append(torch.cat([feat, uv], dim=1) if lvl == 0 else uv)
        neck = self.neck(levels)
        points = self.points_head(neck)[-1]
        mask = self.mask_head(neck)[-1]
        normal = self.normal_head(neck)[-1] if c.use_normal_head else None

        # the metric scale from the cls token; scale_out starts at zero, so a
        # fresh model predicts exp(0) = 1
        h = cls_token.float()
        for i in range(len(c.scale_head_dims) - 1):
            h = F.relu(getattr(self, f"scale{i}")(h))
        metric_scale = torch.exp(self.scale_out(h))[:, 0]

        def up(x):   # NCHW -> [B,H,W,C] float32 at the input's size
            return resize_linear(x.float().permute(0, 2, 3, 1), H, W)

        points = _remap_points(up(points), c.remap_output)
        mask = torch.sigmoid(up(mask)[..., 0])
        if normal is not None:
            normal = up(normal)
            normal = normal / torch.clamp(torch.linalg.vector_norm(normal, dim=-1, keepdim=True),
                                          min=1e-12)
        return dict(points=points, mask=mask, normal=normal, metric_scale=metric_scale)


# --------------------------------------------------------------------------- #
# focal and shift
# --------------------------------------------------------------------------- #

def _shift_cost(shift: torch.Tensor, uv: torch.Tensor, xy: torch.Tensor, z: torch.Tensor,
                w: torch.Tensor, focal: Optional[torch.Tensor] = None):
    """The residual of min_f |f * xy / (z + shift) - uv|^2 over the weighted
    points, for each of K shifts of each image: shift [B,K], uv [N,2], xy
    [B,N,2], z and w [B,N], focal [B] (closed form when None) -> (cost [B,K],
    f [B,K])."""
    denom = z[:, None, :] + shift[..., None]                        # [B,K,N]
    denom = torch.where(denom.abs() < 1e-6, torch.full_like(denom, 1e-6), denom)
    proj = xy[:, None] / denom[..., None]                           # [B,K,N,2]
    wk = w[:, None, :, None]
    if focal is None:
        num = (wk * proj * uv).sum(dim=(-2, -1))
        den = (wk * proj * proj).sum(dim=(-2, -1))
        f = num / torch.clamp(den, min=1e-12)
    else:
        f = focal[:, None].expand_as(shift)
    err = (f[..., None, None] * proj - uv) * wk
    return (err * err).sum(dim=(-2, -1)), f


def solve_focal_shift(
    uv: torch.Tensor,                       # [N,2]
    points: torch.Tensor,                   # [B,N,3] affine point map samples
    mask: Optional[torch.Tensor] = None,    # [B,N]
    focal: Optional[torch.Tensor] = None,   # [B], when the field of view is known
    num_candidates: int = 64,
    refine_iters: int = 30,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The z shift that best makes the points a perspective map (a grid of
    candidates denser near the lowest shift that keeps every weighted point
    in front, then golden-section refinement of the best one's bracket), and
    the focal at it, relative to half the image diagonal. -> (focal [B],
    shift [B])."""
    xy, z = points[..., :2], points[..., 2]
    w = torch.ones_like(z) if mask is None else mask.float()
    zmin = torch.where(w > 0, z, torch.full_like(z, math.inf)).amin(dim=-1)
    lo = -zmin + 1e-3
    hi = lo + 10.0
    ts = torch.from_numpy(np.linspace(0.0, 1.0, num_candidates).astype(np.float32)).to(z.device)
    cands = lo[:, None] + (hi - lo)[:, None] * ts ** 2.0              # [B,K]
    costs, _ = _shift_cost(cands, uv, xy, z, w, focal)
    best = costs.argmin(dim=-1, keepdim=True)
    a = cands.gather(-1, (best - 1).clamp(min=0))[:, 0]
    b = cands.gather(-1, (best + 1).clamp(max=num_candidates - 1))[:, 0]

    gr = (math.sqrt(5.0) - 1) / 2
    for _ in range(refine_iters):
        c1 = b - gr * (b - a)
        c2 = a + gr * (b - a)
        f12, _ = _shift_cost(torch.stack([c1, c2], dim=-1), uv, xy, z, w, focal)
        left = f12[:, 0] < f12[:, 1]
        a, b = torch.where(left, a, c1), torch.where(left, c2, b)
    shift = (a + b) / 2
    _, f = _shift_cost(shift[:, None], uv, xy, z, w, focal)
    return f[:, 0], shift


def recover_focal_shift(
    points: torch.Tensor,                   # [B,H,W,3]
    mask: Optional[torch.Tensor] = None,    # [B,H,W]
    focal: Optional[torch.Tensor] = None,   # [B]
    downsample: Tuple[int, int] = (64, 64),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``solve_focal_shift`` on the point map, its mask and the view-plane UV
    sampled nearest at ``downsample``."""
    B, H, W, _ = points.shape
    uv = normalized_view_plane_uv(H, W, device=points.device)
    pts_lr = resize_nearest(points, (B, *downsample, 3)).reshape(B, -1, 3)
    uv_lr = resize_nearest(uv, (*downsample, 2)).reshape(-1, 2)
    if mask is not None:
        m_lr = resize_nearest(mask.float(), (B, *downsample)).reshape(B, -1) > 0.5
    else:
        m_lr = torch.ones((B, downsample[0] * downsample[1]), dtype=torch.bool,
                          device=points.device)
    return solve_focal_shift(uv_lr, pts_lr, m_lr, focal)


@torch.no_grad()
def moge_infer(
    model: MoGe,
    image: torch.Tensor,                    # [B,H,W,3] in [0, 1]
    num_tokens: Optional[int] = None,
    resolution_level: int = 9,
    fov_x_deg: Optional[float] = None,
) -> MoGeOutput:
    """Forward, focal and shift (or the shift alone for a known field of
    view), the shifted depth, the points re-projected from it, the metric
    scale, and the mask of valid pixels (predicted, and in front)."""
    c = model.cfg
    B, H, W, _ = image.shape
    dev = image.device
    aspect = W / H
    if num_tokens is None:
        lo, hi = c.num_tokens_range
        num_tokens = int(lo + (resolution_level / 9) * (hi - lo))

    out = model(image, num_tokens)
    points, metric_scale = out["points"], out["metric_scale"]
    mask = out["mask"] > 0.5
    if fov_x_deg is None:
        focal, shift = recover_focal_shift(points, mask)
    else:
        fov = torch.as_tensor(fov_x_deg, dtype=torch.float32, device=dev)
        focal = (aspect / (1 + aspect ** 2) ** 0.5 / torch.tan(torch.deg2rad(fov) / 2)
                 ).expand(B).contiguous()
        _, shift = recover_focal_shift(points, mask, focal=focal)

    fx = focal / 2 * (1 + aspect ** 2) ** 0.5 / aspect
    fy = focal / 2 * (1 + aspect ** 2) ** 0.5
    intrinsics = torch.zeros((B, 3, 3), dtype=torch.float32, device=dev)
    intrinsics[:, 0, 0], intrinsics[:, 1, 1] = fx, fy
    intrinsics[:, 0, 2] = intrinsics[:, 1, 2] = 0.5
    intrinsics[:, 2, 2] = 1.0

    depth = points[..., 2] + shift[:, None, None]
    mask = mask & (depth > 0)
    u = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
    v = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    x = (uu[None] - 0.5) / fx[:, None, None] * depth
    y = (vv[None] - 0.5) / fy[:, None, None] * depth
    points = torch.stack([x, y, depth], dim=-1) * metric_scale[:, None, None, None]
    depth = depth * metric_scale[:, None, None]
    return MoGeOutput(
        points=points, depth=depth, normal=out["normal"], mask=mask, intrinsics=intrinsics,
        metric_scale=metric_scale, fov_x_deg=torch.rad2deg(2 * torch.atan(0.5 / fx)),
        fov_y_deg=torch.rad2deg(2 * torch.atan(0.5 / fy)))
