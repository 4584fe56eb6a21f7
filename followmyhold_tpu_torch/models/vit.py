"""Vision transformer encoder in PyTorch: the DINOv2 path and HaMeR's ViT-H.

Counterpart of followmyhold_tpu/models/vit.py, which serves HaMeR's ViT-H/16,
MoGe's DINOv2-L/14 (``DINOV2_VIT_L``) and the Hunyuan conditioner's DINOv2-G/14. HaMeR's
backbone (``HAMER_VIT_H``, ``ViTFeatureMap``) pads its patch convolution by
2 px and adds the position embedding's cls slot to every patch token; its
192 tokens at head size 80 take the plain attention, as in the reference
(the flash path needs 256 or more). Module and
parameter names follow the Flax modules, so ``utils.params.flax_to_torch``
loads a Flax tree mechanically: the scan-stacked blocks (``blocks/block/...``
with a leading depth axis) land on ``blocks.<i>``, and the patch embedding's
HWIO conv kernel is permuted onto the OIHW ``Conv2d`` weight (the images stay
channels-last at the entry and are viewed as NCHW for the convolution).

Numerics kept from the reference: LayerNorm in float32 with epsilon 1e-6
(Flax's default, not torch's 1e-5), cast back to the activation type; the
layerscale gammas are float32 parameters cast to the activation type; GELU is
exact; attention goes through ``ops.attention.multi_head_attention``, so the
flash-attention kernel serves the long sequences (DINOv2-G's 1,370 tokens and
DINOv2-L's 3,601 on MoGe's 60x60 grid, both at head size 64).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from followmyhold_tpu_torch.models.hunyuan import LayerNormF32, _merge_heads, _split_heads
from followmyhold_tpu_torch.ops.attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: Tuple[int, int] = (256, 192)   # (H, W)
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    use_cls_token: bool = False
    num_register_tokens: int = 0
    layerscale_init: Optional[float] = None  # DINOv2 uses 1e-5
    # ViTPose-style patch embedding pads the conv (HaMeR: 2 px)
    patch_padding: int = 0
    # HaMeR keeps a cls slot in pos_embed without a cls token and adds it to
    # every patch token
    pos_embed_cls_slot: bool = False
    # "mlp" (fc1 / gelu / fc2) or "swiglu" (DINOv2-G: w12 -> silu(x1) * x2 -> w3)
    ffn: str = "mlp"
    # DINOv2's interpolate_pos_encoding samples with scale (dst + offset) / src
    pos_interp_offset: float = 0.0
    # input channels (Flax infers them from the first call; 4 with a mask)
    in_chans: int = 3
    dtype: torch.dtype = torch.bfloat16

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.patch_size, self.img_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid
        return gh * gw


HAMER_VIT_H = ViTConfig(patch_padding=2, pos_embed_cls_slot=True)

# MoGe's encoder: 37x37 position embeddings, resized to the crop's grid (60x60
# on a 512^2 crop at resolution level 9) with DINOv2's offset
DINOV2_VIT_L = ViTConfig(
    img_size=(518, 518), patch_size=14, embed_dim=1024, depth=24, num_heads=16,
    use_cls_token=True, layerscale_init=1e-5, pos_interp_offset=0.1,
)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.qkv = nn.Linear(c.embed_dim, 3 * c.embed_dim, bias=c.qkv_bias, dtype=c.dtype,
                             device=device)
        self.proj = nn.Linear(c.embed_dim, c.embed_dim, dtype=c.dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_split_heads(t, self.cfg.num_heads) for t in self.qkv(x).chunk(3, dim=-1))
        out = multi_head_attention(q, k, v, device=x.device)
        return self.proj(_merge_heads(out))


def swiglu_hidden(embed_dim: int, mlp_ratio: float) -> int:
    """DINOv2's SwiGLUFFNFused hidden width: 2/3 of the MLP's, rounded up to 8."""
    return ((int(embed_dim * mlp_ratio * 2 / 3) + 7) // 8) * 8


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        if c.ffn == "swiglu":
            hidden = swiglu_hidden(c.embed_dim, c.mlp_ratio)
            self.w12 = nn.Linear(c.embed_dim, 2 * hidden, dtype=c.dtype, device=device)
            self.w3 = nn.Linear(hidden, c.embed_dim, dtype=c.dtype, device=device)
        elif c.ffn == "mlp":
            hidden = int(c.embed_dim * c.mlp_ratio)
            self.fc1 = nn.Linear(c.embed_dim, hidden, dtype=c.dtype, device=device)
            self.fc2 = nn.Linear(hidden, c.embed_dim, dtype=c.dtype, device=device)
        else:
            raise ValueError(f"unknown ffn {c.ffn!r}, expected 'mlp' or 'swiglu'")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.ffn == "swiglu":
            x1, x2 = self.w12(x).chunk(2, dim=-1)
            return self.w3(F.silu(x1) * x2)
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.norm1 = LayerNormF32(c.embed_dim, True, c.dtype, device)
        self.attn = Attention(c, device)
        self.norm2 = LayerNormF32(c.embed_dim, True, c.dtype, device)
        self.mlp = Mlp(c, device)
        if c.layerscale_init is not None:
            self.ls1 = nn.Parameter(torch.full((c.embed_dim,), c.layerscale_init,
                                               dtype=torch.float32, device=device))
            self.ls2 = nn.Parameter(torch.full((c.embed_dim,), c.layerscale_init,
                                               dtype=torch.float32, device=device))

    def _scale(self, y: torch.Tensor, gamma: Optional[nn.Parameter]) -> torch.Tensor:
        return y if gamma is None else y * gamma.to(y.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scaled = self.cfg.layerscale_init is not None
        x = x + self._scale(self.attn(self.norm1(x)), self.ls1 if scaled else None)
        return x + self._scale(self.mlp(self.norm2(x)), self.ls2 if scaled else None)


def _torch_bicubic_weights(src: int, dst: int, scale: float) -> np.ndarray:
    """[dst, src] sampling matrix of ``F.interpolate(mode='bicubic',
    align_corners=False, antialias=False)``: output i samples input coordinate
    (i + 0.5) / scale - 0.5 through the Keys kernel with a = -0.75 and
    edge-clamped taps. The reference builds this matrix so that its JAX resize
    of the position embedding equals the original torch code's."""
    a = -0.75
    W = np.zeros((dst, src), np.float64)
    for i in range(dst):
        x = (i + 0.5) / scale - 0.5
        x0 = int(np.floor(x))
        t = x - x0
        for k in range(-1, 3):
            tt = abs(t - k)
            if tt <= 1.0:
                w = (a + 2) * tt ** 3 - (a + 3) * tt ** 2 + 1
            elif tt < 2.0:
                w = a * tt ** 3 - 5 * a * tt ** 2 + 8 * a * tt - 4 * a
            else:
                continue
            W[i, min(max(x0 + k, 0), src - 1)] += w
    return W.astype(np.float32)


def interpolate_pos_embed(pos: torch.Tensor, src_grid, dst_grid,
                          offset: float = 0.0) -> torch.Tensor:
    """Bicubic resize of a [1, gh*gw, C] position embedding with torch's
    semantics (DINOv2: scale (dst + offset) / src)."""
    if tuple(src_grid) == tuple(dst_grid):
        return pos
    c = pos.shape[-1]
    grid = pos.reshape(src_grid[0], src_grid[1], c).float()
    wy = torch.from_numpy(_torch_bicubic_weights(
        src_grid[0], dst_grid[0], (dst_grid[0] + offset) / src_grid[0])).to(pos.device)
    wx = torch.from_numpy(_torch_bicubic_weights(
        src_grid[1], dst_grid[1], (dst_grid[1] + offset) / src_grid[1])).to(pos.device)
    out = torch.einsum("ij,jkc->ikc", wy, grid)
    out = torch.einsum("kj,ijc->ikc", wx, out)
    return out.reshape(1, dst_grid[0] * dst_grid[1], c)


class ViT(nn.Module):
    """images [B, H, W, in_chans] float -> final tokens [B, N, C] (patch tokens only),
    cls (+ registers) + patches with ``keep_prefix``, or, with ``out_layers``,
    (the listed layers' patch tokens after the final norm, the final patch
    tokens, the cls token)."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        pp = c.patch_padding
        self.patch_embed = nn.Conv2d(c.in_chans, c.embed_dim, c.patch_size, stride=c.patch_size,
                                     padding=pp, dtype=c.dtype, device=device)
        has_cls_slot = c.use_cls_token or c.pos_embed_cls_slot
        self.pos_embed = nn.Parameter(torch.zeros(
            (1, c.num_patches + (1 if has_cls_slot else 0), c.embed_dim),
            dtype=torch.float32, device=device))
        if c.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros((1, 1, c.embed_dim), dtype=torch.float32,
                                                      device=device))
            if c.num_register_tokens:
                self.register_tokens = nn.Parameter(torch.zeros(
                    (1, c.num_register_tokens, c.embed_dim), dtype=torch.float32,
                    device=device))
        self.blocks = nn.ModuleList(Block(c, device) for _ in range(c.depth))
        self.norm = LayerNormF32(c.embed_dim, True, c.dtype, device)

    def forward(self, images: torch.Tensor, out_layers: Optional[Sequence[int]] = None,
                keep_prefix: bool = False):
        c = self.cfg
        B = images.shape[0]
        # channels-last images, viewed as NCHW for the convolution
        x = self.patch_embed(images.to(c.dtype).permute(0, 3, 1, 2))   # [B, C, gh, gw]
        gh, gw = x.shape[2], x.shape[3]
        x = x.flatten(2).transpose(1, 2)                                # [B, gh*gw, C]

        n_prefix = (1 if c.use_cls_token else 0) + c.num_register_tokens
        pos = self.pos_embed
        if c.use_cls_token or c.pos_embed_cls_slot:
            cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
        else:
            cls_pos, patch_pos = None, pos
        patch_pos = interpolate_pos_embed(patch_pos, c.grid, (gh, gw), c.pos_interp_offset)
        if c.pos_embed_cls_slot and not c.use_cls_token:
            patch_pos = patch_pos + cls_pos
        x = x + patch_pos.to(c.dtype)
        if c.use_cls_token:
            tokens = [(self.cls_token + cls_pos).to(c.dtype).expand(B, -1, -1)]
            if c.num_register_tokens:
                tokens.append(self.register_tokens.to(c.dtype).expand(B, -1, -1))
            tokens.append(x)
            x = torch.cat(tokens, dim=1)

        collected = []
        for block in self.blocks:
            x = block(x)
            if out_layers is not None:
                collected.append(x)
        x = self.norm(x)

        if out_layers is not None:
            # DINOv2's get_intermediate_layers applies the final norm to every
            # collected layer
            layers = [self.norm(collected[i])[:, n_prefix:] for i in out_layers]
            return layers, x[:, n_prefix:], (x[:, 0] if c.use_cls_token else None)
        if keep_prefix:
            return x
        return x[:, n_prefix:]


class ViTFeatureMap(nn.Module):
    """HaMeR's backbone wrapper: images [B,H,W,3] -> feature map [B,gh,gw,C]."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.vit = ViT(cfg, device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, H, W, _ = images.shape
        pp = c.patch_padding
        gh = (H + 2 * pp - c.patch_size) // c.patch_size + 1
        gw = (W + 2 * pp - c.patch_size) // c.patch_size + 1
        return self.vit(images).reshape(B, gh, gw, c.embed_dim)
