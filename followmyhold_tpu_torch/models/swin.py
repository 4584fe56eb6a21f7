"""Swin Transformer backbone in PyTorch: GroundingDINO's vision encoder.

Counterpart of followmyhold_tpu/models/swin.py (the HF Swin backbone, so the
grounding-dino-base checkpoint's Swin-B maps onto it): a 4x4 patch embedding
and LayerNorm, no absolute position embedding; stages of window attention
with a learned relative position bias and a cyclic shift on odd blocks (the
window never shrinks for small inputs); patch merging between stages; a
LayerNorm on each output stage, taken before its downsample.

Each stage pads its map at the bottom and right to a multiple of the window
(at GroundingDINO's 800^2: 200, 100, 50 and 25 to 204, 108, 60 and 36 with
window 12), after the LayerNorm, with zeros, and the shifted blocks add the
-100/0 mask of the padded map, as the reference does. The attention is
written out in plain PyTorch (144 tokens a window, head size 32): logits and
softmax in float32, both products on the bf16 tensors' values. The blocks
run NHWC (tokens), the patch embedding NCHW on cuDNN.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from followmyhold_tpu_torch.models.hunyuan import LayerNormF32


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 128                      # swin-base
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-5
    # which stage outputs to emit (1-indexed stages, pre-downsample)
    out_stages: Tuple[int, ...] = (2, 3, 4)
    dtype: torch.dtype = torch.bfloat16

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * 2 ** i for i in range(len(self.depths)))

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return tuple(self.stage_dims[s - 1] for s in self.out_stages)


SWIN_B = SwinConfig()
SWIN_TINY_TEST = SwinConfig(embed_dim=16, depths=(1, 1, 1), num_heads=(1, 2, 4),
                            window_size=4, out_stages=(2, 3), dtype=torch.float32)


def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * H/w * W/w, w*w, C], windows batch-major then row-major."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def _window_reverse(windows: torch.Tensor, w: int, H: int, W: int) -> torch.Tensor:
    C = windows.shape[-1]
    x = windows.reshape(-1, H // w, W // w, w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, H, W, C)


def _relative_position_index(w: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)                        # [w*w, w*w]


def _shift_attn_mask(hp: int, wp: int, w: int, shift: int) -> np.ndarray:
    """The additive mask [num_windows, w*w, w*w] of shifted windows (-100/0)."""
    img = np.zeros((1, hp, wp, 1), np.float32)
    slices = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[:, hs, ws, :] = cnt
            cnt += 1
    mw = _window_partition(torch.from_numpy(img), w).numpy()[:, :, 0]   # [nw, w*w]
    attn = mw[:, None, :] - mw[:, :, None]
    return np.where(attn != 0, -100.0, 0.0).astype(np.float32)


class SwinSelfAttention(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, heads: int, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.dim, self.heads = dim, heads
        w = c.window_size
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * w - 1) * (2 * w - 1), heads, dtype=torch.float32, device=device))
        kw = dict(dtype=c.dtype, device=device)
        self.query = nn.Linear(dim, dim, bias=c.qkv_bias, **kw)
        self.key = nn.Linear(dim, dim, bias=c.qkv_bias, **kw)
        self.value = nn.Linear(dim, dim, bias=c.qkv_bias, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        self.register_buffer("rel_idx", torch.from_numpy(
            _relative_position_index(w).reshape(-1)).to(device), persistent=False)

    def forward(self, x: torch.Tensor, attn_mask) -> torch.Tensor:
        c = self.cfg
        nB, N, _ = x.shape            # nB = B * num_windows, N = w*w
        hd = self.dim // self.heads
        rel_bias = self.relative_position_bias_table[self.rel_idx].reshape(N, N, self.heads)
        rel_bias = rel_bias.permute(2, 0, 1)                 # [h, N, N]

        def split(t):
            return t.reshape(nB, N, self.heads, hd).permute(0, 2, 1, 3)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / float(hd) ** 0.5
        logits = logits + rel_bias[None]
        if attn_mask is not None:
            nw = attn_mask.shape[0]
            logits = logits.reshape(nB // nw, nw, self.heads, N, N) + attn_mask[None, :, None]
            logits = logits.reshape(nB, self.heads, N, N)
        probs = torch.softmax(logits, dim=-1).to(c.dtype)
        out = torch.matmul(probs.float(), v.float()).to(c.dtype)
        out = out.permute(0, 2, 1, 3).reshape(nB, N, self.dim)
        return self.proj(out)


class SwinLayer(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, heads: int, shift: int, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.shift = shift
        eps = c.layer_norm_eps
        self.layernorm_before = LayerNormF32(dim, True, c.dtype, device, eps=eps)
        self.attn = SwinSelfAttention(c, dim, heads, device)
        self.layernorm_after = LayerNormF32(dim, True, c.dtype, device, eps=eps)
        hidden = int(c.mlp_ratio * dim)
        self.intermediate = nn.Linear(dim, hidden, dtype=c.dtype, device=device)
        self.output = nn.Linear(hidden, dim, dtype=c.dtype, device=device)
        self._masks = {}

    def _mask(self, hp: int, wp: int, device) -> torch.Tensor:
        key = (hp, wp, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(_shift_attn_mask(
                hp, wp, self.cfg.window_size, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, C]."""
        w = self.cfg.window_size
        B, H, W, C = x.shape
        shortcut = x
        h = self.layernorm_before(x)
        pad_b = (w - H % w) % w
        pad_r = (w - W % w) % w
        h = F.pad(h, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        attn_mask = None
        if self.shift > 0:
            h = torch.roll(h, (-self.shift, -self.shift), dims=(1, 2))
            attn_mask = self._mask(Hp, Wp, h.device)
        h = _window_reverse(self.attn(_window_partition(h, w), attn_mask), w, Hp, Wp)
        if self.shift > 0:
            h = torch.roll(h, (self.shift, self.shift), dims=(1, 2))
        x = shortcut + h[:, :H, :W]
        h = F.gelu(self.intermediate(self.layernorm_after(x)))
        return x + self.output(h)


class SwinPatchMerging(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.norm = LayerNormF32(4 * dim, True, c.dtype, device, eps=c.layer_norm_eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, dtype=c.dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinBackbone(nn.Module):
    """[B, H, W, 3] -> the NHWC feature maps of ``cfg.out_stages``."""

    def __init__(self, cfg: SwinConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        p = c.patch_size
        self.patch_embed = nn.Conv2d(3, c.embed_dim, p, stride=p, dtype=c.dtype, device=device)
        self.embed_norm = LayerNormF32(c.embed_dim, True, c.dtype, device, eps=1e-5)
        for s, (depth, heads) in enumerate(zip(c.depths, c.num_heads)):
            dim = c.stage_dims[s]
            for b in range(depth):
                shift = 0 if b % 2 == 0 else c.window_size // 2
                self.add_module(f"stage{s}_block{b}", SwinLayer(c, dim, heads, shift, device))
            if (s + 1) in c.out_stages:
                self.add_module(f"out_norm{s + 1}",
                                LayerNormF32(dim, True, c.dtype, device, eps=1e-5))
            if s < len(c.depths) - 1:
                self.add_module(f"downsample{s}", SwinPatchMerging(c, dim, device))

    def forward(self, pixel_values: torch.Tensor) -> List[torch.Tensor]:
        c = self.cfg
        B, H, W, _ = pixel_values.shape
        p = c.patch_size
        x = pixel_values.to(self.patch_embed.weight.device, c.dtype)
        x = F.pad(x, (0, 0, 0, (p - W % p) % p, 0, (p - H % p) % p))
        x = self.patch_embed(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)   # NHWC
        x = self.embed_norm(x)
        outs = []
        for s, depth in enumerate(c.depths):
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x)
            if (s + 1) in c.out_stages:
                outs.append(getattr(self, f"out_norm{s + 1}")(x))
            if s < len(c.depths) - 1:
                x = getattr(self, f"downsample{s}")(x)
        return outs
