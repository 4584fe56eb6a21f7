"""Hunyuan3D-2 shape-generation stack in PyTorch: flow-matching DiT and
ShapeVAE decoder with its occupancy head.

Counterpart of followmyhold_tpu/models/hunyuan.py. Module and parameter names
follow the Flax modules, so ``utils.params.flax_to_torch`` can load a Flax
parameter tree mechanically; the scan-stacked blocks of the reference are one
module per layer here.

Numerics kept from the reference: LayerNorm and RMSNorm run in float32 with
epsilon 1e-6 and cast back to the block's type; most DiT LayerNorms have no
scale or bias; QK-RMSNorm is per head; GELU is tanh-approximate in the DiT and
exact in the VAE; ``final_proj`` and the geo ``logit`` head are float32; the
joint sequence is condition tokens first, then latents.

The grid decode is differentiable (the guided sampler's object and joint
phases differentiate through it every iteration), with the reference's
rematerialisation knobs: ``ShapeVAEConfig.remat_blocks`` checkpoints each
decoder block, and the geo-decoder query takes ``remat`` in
{'full', 'tail', 'none'}; none of them changes the numbers. The in-loop
two-level decode, ``vae_query_logits_hier_grid``, refines only the cells near
the surface; the export's two-level decode, ``hierarchical_export_logits``,
does the same at 384^3 with the compose on the host. The image conditioner
(DINOv2-G, ``models/vit.py``) turns the object crop into condition tokens.
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from followmyhold_tpu_torch.ops.attention import multi_head_attention
from followmyhold_tpu_torch.ops.indexing import (
    first_per_image,
    image_offsets,
    take_image_rows,
    take_rows,
)

_NORM_EPS = 1e-6  # Flax's default, not torch's 1e-5


# ---------------------------------------------------------------------------
# common blocks
# ---------------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding of t in [0,1] (scaled by 1000; cos before sin)."""
    t = t.float() * 1000.0
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class LayerNormF32(nn.Module):
    """LayerNorm computed in float32, result cast to ``out_dtype``."""

    def __init__(self, dim: int, affine: bool, out_dtype: torch.dtype, device=None,
                 eps: float = _NORM_EPS):
        super().__init__()
        self.dim = dim
        self.out_dtype = out_dtype
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
            self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))
        else:
            self.weight = None
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (self.dim,), self.weight, self.bias, self.eps)
        return y.to(self.out_dtype)


class RMSNormF32(nn.Module):
    """RMSNorm over the last axis with a learned scale, computed in float32."""

    def __init__(self, dim: int, out_dtype: torch.dtype, device=None):
        super().__init__()
        self.out_dtype = out_dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + _NORM_EPS)
        return (y * self.weight).to(self.out_dtype)


def _linear(n_in: int, n_out: int, dtype, device) -> nn.Linear:
    return nn.Linear(n_in, n_out, dtype=dtype, device=device)


class MlpEmbedder(nn.Module):
    def __init__(self, n_in: int, hidden: int, dtype, device=None):
        super().__init__()
        self.in_layer = _linear(n_in, hidden, dtype, device)
        self.out_layer = _linear(hidden, hidden, dtype, device)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, N, D = x.shape
    return x.reshape(B, N, heads, D // heads).permute(0, 2, 1, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, N, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, N, H * D)


def _attention(q, k, v):
    return multi_head_attention(q, k, v, device=q.device)


class Modulation(nn.Module):
    def __init__(self, hidden: int, n_mods: int, dtype, device=None):
        super().__init__()
        self.n_mods = n_mods
        self.lin = _linear(hidden, n_mods * hidden, dtype, device)

    def forward(self, vec):
        out = self.lin(F.silu(vec))
        return out[:, None, :].chunk(self.n_mods, dim=-1)


def _modulate(x, shift, scale):
    return x * (1 + scale) + shift


class DoubleStreamBlock(nn.Module):
    """Joint attention over (latent, cond) streams with per-stream adaLN."""

    def __init__(self, hidden: int, heads: int, mlp_ratio: float, dtype, device=None):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        head_dim = hidden // heads
        mlp_dim = int(hidden * mlp_ratio)
        for name in ("img", "txt"):
            setattr(self, f"{name}_mod", Modulation(hidden, 6, dtype, device))
            setattr(self, f"{name}_norm1", LayerNormF32(hidden, False, dtype))
            setattr(self, f"{name}_qkv", _linear(hidden, 3 * hidden, dtype, device))
            setattr(self, f"{name}_qnorm", RMSNormF32(head_dim, dtype, device))
            setattr(self, f"{name}_knorm", RMSNormF32(head_dim, dtype, device))
            setattr(self, f"{name}_proj", _linear(hidden, hidden, dtype, device))
            setattr(self, f"{name}_norm2", LayerNormF32(hidden, False, dtype))
            setattr(self, f"{name}_mlp1", _linear(hidden, mlp_dim, dtype, device))
            setattr(self, f"{name}_mlp2", _linear(mlp_dim, hidden, dtype, device))

    def _qkv(self, stream, name):
        q, k, v = getattr(self, f"{name}_qkv")(stream).chunk(3, dim=-1)
        q = getattr(self, f"{name}_qnorm")(_split_heads(q, self.heads))
        k = getattr(self, f"{name}_knorm")(_split_heads(k, self.heads))
        return q, k, _split_heads(v, self.heads)

    def _mlp(self, stream, shift, scale, gate, name):
        s = _modulate(getattr(self, f"{name}_norm2")(stream), shift, scale)
        s = F.gelu(getattr(self, f"{name}_mlp1")(s), approximate="tanh")
        return stream + gate * getattr(self, f"{name}_mlp2")(s)

    def forward(self, x, c, vec):
        x_mods = self.img_mod(vec)
        c_mods = self.txt_mod(vec)
        xn = _modulate(self.img_norm1(x), x_mods[0], x_mods[1])
        cn = _modulate(self.txt_norm1(c), c_mods[0], c_mods[1])

        xq, xk, xv = self._qkv(xn, "img")
        cq, ck, cv = self._qkv(cn, "txt")
        q = torch.cat([cq, xq], dim=2)
        k = torch.cat([ck, xk], dim=2)
        v = torch.cat([cv, xv], dim=2)
        attn = _merge_heads(_attention(q, k, v))
        c_attn, x_attn = attn[:, : c.shape[1]], attn[:, c.shape[1]:]

        x = x + x_mods[2] * self.img_proj(x_attn)
        c = c + c_mods[2] * self.txt_proj(c_attn)
        x = self._mlp(x, x_mods[3], x_mods[4], x_mods[5], "img")
        c = self._mlp(c, c_mods[3], c_mods[4], c_mods[5], "txt")
        return x, c


class SingleStreamBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_ratio: float, dtype, device=None):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        mlp_dim = int(hidden * mlp_ratio)
        self.mod = Modulation(hidden, 3, dtype, device)
        self.pre_norm = LayerNormF32(hidden, False, dtype)
        self.linear1 = _linear(hidden, 3 * hidden + mlp_dim, dtype, device)
        self.qnorm = RMSNormF32(hidden // heads, dtype, device)
        self.knorm = RMSNormF32(hidden // heads, dtype, device)
        self.linear2 = _linear(hidden + mlp_dim, hidden, dtype, device)

    def forward(self, x, vec):
        h = self.hidden
        mods = self.mod(vec)
        xn = _modulate(self.pre_norm(x), mods[0], mods[1])
        q, k, v, m = self.linear1(xn).split([h, h, h, self.linear1.out_features - 3 * h], dim=-1)
        q = self.qnorm(_split_heads(q, self.heads))
        k = self.knorm(_split_heads(k, self.heads))
        attn = _merge_heads(_attention(q, k, _split_heads(v, self.heads)))
        out = self.linear2(torch.cat([attn, F.gelu(m, approximate="tanh")], dim=-1))
        return x + mods[2] * out


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiTConfig:
    in_channels: int = 64
    context_dim: int = 1536          # conditioner token dim
    hidden: int = 2048
    heads: int = 16
    depth_double: int = 8
    depth_single: int = 16
    mlp_ratio: float = 4.0
    guidance_embed: bool = False     # lcm-distilled variants embed the scale
    time_dim: int = 256
    dtype: torch.dtype = torch.bfloat16


DIT_FULL = DiTConfig()
DIT_TINY = DiTConfig(hidden=64, heads=4, depth_double=1, depth_single=2,
                     context_dim=32, time_dim=32, dtype=torch.float32)


class HunyuanDiT(nn.Module):
    """eps = DiT(latents, t, cond): flow-matching velocity prediction."""

    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        self.cfg = c = cfg
        self.latent_in = _linear(c.in_channels, c.hidden, c.dtype, device)
        self.cond_in = _linear(c.context_dim, c.hidden, c.dtype, device)
        self.time_in = MlpEmbedder(c.time_dim, c.hidden, c.dtype, device)
        if c.guidance_embed:
            self.guidance_in = MlpEmbedder(c.time_dim, c.hidden, c.dtype, device)
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(c.hidden, c.heads, c.mlp_ratio, c.dtype, device)
            for _ in range(c.depth_double))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(c.hidden, c.heads, c.mlp_ratio, c.dtype, device)
            for _ in range(c.depth_single))
        self.final_mod = Modulation(c.hidden, 2, c.dtype, device)
        self.final_norm = LayerNormF32(c.hidden, False, c.dtype)
        self.final_proj = _linear(c.hidden, c.in_channels, torch.float32, device)

    def forward(
        self,
        latents: torch.Tensor,   # [B, L, in_channels]
        timestep: torch.Tensor,  # [B] in [0,1]
        cond: torch.Tensor,      # [B, M, context_dim]
        guidance: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        c = self.cfg
        x = self.latent_in(latents.to(c.dtype))
        ctx = self.cond_in(cond.to(c.dtype))
        vec = self.time_in(timestep_embedding(timestep, c.time_dim).to(c.dtype))
        if c.guidance_embed:
            g = torch.zeros_like(timestep) if guidance is None else guidance
            vec = vec + self.guidance_in(
                timestep_embedding(g / 1000.0, c.time_dim).to(c.dtype))

        for block in self.double_blocks:
            x, ctx = block(x, ctx, vec)
        s = torch.cat([ctx, x], dim=1)
        for block in self.single_blocks:
            s = block(s, vec)
        x = s[:, ctx.shape[1]:]

        shift, scale = self.final_mod(vec)
        x = _modulate(self.final_norm(x), shift, scale)
        return self.final_proj(x.float())


# ---------------------------------------------------------------------------
# ShapeVAE (decode path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeVAEConfig:
    num_latents: int = 3072
    embed_dim: int = 64
    width: int = 1024
    heads: int = 16
    depth: int = 16
    geo_heads: int = 16
    fourier_freqs: int = 8
    scale_factor: float = 1.0039506158752403  # hy3dgen shapevae default
    # recompute each decoder block in the backward instead of keeping its
    # activations (the reference's default); no effect without autograd
    remat_blocks: bool = True
    dtype: torch.dtype = torch.bfloat16


VAE_FULL = ShapeVAEConfig()
VAE_TINY = ShapeVAEConfig(num_latents=16, embed_dim=8, width=32, heads=4,
                          depth=1, geo_heads=4, dtype=torch.float32)


def fourier_embed(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[..., 3] -> [..., 3 * (2*num_freqs + 1)] (include input)."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=torch.float32, device=x.device)
    ang = x[..., None] * freqs  # [..., 3, F]
    emb = torch.cat([x[..., None], torch.sin(ang), torch.cos(ang)], dim=-1)
    return emb.reshape(*x.shape[:-1], -1)


class VAESelfBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype, device=None):
        super().__init__()
        self.heads = heads
        self.ln1 = LayerNormF32(width, True, dtype, device)
        self.qkv = _linear(width, 3 * width, dtype, device)
        self.proj = _linear(width, width, dtype, device)
        self.ln2 = LayerNormF32(width, True, dtype, device)
        self.fc1 = _linear(width, 4 * width, dtype, device)
        self.fc2 = _linear(4 * width, width, dtype, device)

    def forward(self, x):
        q, k, v = (_split_heads(t, self.heads) for t in self.qkv(self.ln1(x)).chunk(3, dim=-1))
        x = x + self.proj(_merge_heads(_attention(q, k, v)))
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


class ShapeVAEDecoder(nn.Module):
    """latents [B,L,E] -> feature set [B,L,width]."""

    def __init__(self, cfg: ShapeVAEConfig, device=None):
        super().__init__()
        self.cfg = c = cfg
        self.post_kl = _linear(c.embed_dim, c.width, c.dtype, device)
        self.blocks = nn.ModuleList(
            VAESelfBlock(c.width, c.heads, c.dtype, device) for _ in range(c.depth))
        self.ln_post = LayerNormF32(c.width, True, c.dtype, device)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        x = self.post_kl(latents.to(self.cfg.dtype))
        remat = self.cfg.remat_blocks and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return self.ln_post(x)


class GeoDecoder(nn.Module):
    """Occupancy-logit query head: cross-attend Fourier-embedded points to the
    decoded latent set: a cross-attention residual (lnq on queries, lnkv on the
    latent set), an MLP residual (ln3 -> fc1 -> GELU -> fc2), then ln_out and
    the logit head.

    Split into kv_feats (per decoded latent set, computed ONCE) and query (per
    chunk of points), so a chunked grid decode does not re-project the k/v of
    all latent tokens for every chunk."""

    def __init__(self, cfg: ShapeVAEConfig, device=None):
        super().__init__()
        self.cfg = c = cfg
        n_embed = 3 * (2 * c.fourier_freqs + 1)
        self.heads = c.geo_heads          # this rank's heads under tensor parallelism
        self.query_in = _linear(n_embed, c.width, c.dtype, device)
        self.lnq = LayerNormF32(c.width, True, c.dtype, device)
        self.kv = _linear(c.width, 2 * c.width, c.dtype, device)
        self.lnkv = LayerNormF32(c.width, True, c.dtype, device)
        self.q = _linear(c.width, c.width, c.dtype, device)
        self.proj = _linear(c.width, c.width, c.dtype, device)
        self.ln3 = LayerNormF32(c.width, True, c.dtype, device)
        self.fc1 = _linear(c.width, 4 * c.width, c.dtype, device)
        self.fc2 = _linear(4 * c.width, c.width, c.dtype, device)
        self.ln_out = LayerNormF32(c.width, True, torch.float32, device)
        self.logit = _linear(c.width, 1, torch.float32, device)

    def kv_feats(self, features: torch.Tensor) -> torch.Tensor:
        """[B,L,width] -> merged k,v [B,L,2*width]."""
        return self.kv(self.lnkv(features))

    def query_head(self, queries: torch.Tensor, kv: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Embedding, projections and the cross-attention: the part whose
        saved tensors the 'tail' remat mode keeps. -> (q, merged attention)."""
        c = self.cfg
        q = self.query_in(fourier_embed(queries, c.fourier_freqs).to(c.dtype))
        k, v = kv.chunk(2, dim=-1)
        qh = _split_heads(self.q(self.lnq(q)), self.heads)
        attn = _attention(qh, _split_heads(k, self.heads), _split_heads(v, self.heads))
        return q, _merge_heads(attn)

    def query_tail(self, q: torch.Tensor, attn_merged: torch.Tensor) -> torch.Tensor:
        """Residual projection, MLP and logit head: cheap to recompute, and
        its fc1 activation [N, 4*width] is the largest saved tensor."""
        x = q + self.proj(attn_merged)
        x = x + self.fc2(F.gelu(self.fc1(self.ln3(x))))
        return self.logit(self.ln_out(x))[..., 0]

    def query(self, queries: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """queries [B,N,3] x kv [B,L,2*width] -> logits [B,N] float32."""
        return self.query_tail(*self.query_head(queries, kv))

    def forward(self, queries: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
        return self.query(queries, self.kv_feats(features))


class ShapeVAE(nn.Module):
    """Decoder + geo head. ``forward(latents, queries)`` touches both;
    queries=None returns the decoded feature set only."""

    def __init__(self, cfg: ShapeVAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.decoder = ShapeVAEDecoder(cfg, device)
        self.geo = GeoDecoder(cfg, device)

    def forward(self, latents: torch.Tensor,
                queries: Optional[torch.Tensor] = None) -> torch.Tensor:
        feats = self.decoder(latents)
        if queries is None:
            return feats
        return self.geo(queries, feats)


def vae_decode_kv(vae: ShapeVAE, latents: torch.Tensor) -> torch.Tensor:
    """Scaled ShapeVAE decode + geo k/v projection (once per decode, not once
    per query chunk)."""
    return vae.geo.kv_feats(vae.decoder(latents / vae.cfg.scale_factor))


_REMAT_MODES = ("full", "tail", "none")


def _geo_query_grouped(
    vae: ShapeVAE,
    kv: torch.Tensor,          # [B, L, 2*width] precomputed geo k/v
    queries: torch.Tensor,     # [B, N, 3]
    chunk: int = 8192,
    group: int = 4,
    remat: str = "none",
) -> torch.Tensor:
    """Chunked and grouped geo-decoder query against precomputed k/v -> raw
    logits [B, N] float32.

    ``group`` chunks are stacked on the batch axis per call, so one attention
    launch covers group x chunk query points against the shared k/v; group
    sizes are equalised over the groups so that the last is not mostly
    padding. Under autograd ``remat`` chooses what the backward recomputes:

      'full': checkpoint each group's whole query, the attention's forward
              kernel included (it runs again in the backward);
      'tail': keep the attention head's tensors and checkpoint only the
              projection + MLP tail, whose fc1 activation is the largest;
      'none': keep everything.

    The numbers are the same in every mode.
    """
    if remat not in _REMAT_MODES:
        raise ValueError(f"unknown remat mode {remat!r}, expected one of {_REMAT_MODES}")
    B, N, _ = queries.shape
    if N == 0:
        return torch.zeros((B, 0), dtype=torch.float32, device=queries.device)
    pad = (-N) % chunk
    qp = F.pad(queries, (0, 0, 0, pad))
    qc = qp.reshape(B, -1, chunk, 3).transpose(0, 1)            # [n_chunks,B,chunk,3]
    n_chunks = qc.shape[0]
    group = max(1, min(group, n_chunks))
    n_groups = -(-n_chunks // group)
    group = -(-n_chunks // n_groups)
    qc = F.pad(qc, (0, 0, 0, 0, 0, 0, 0, n_groups * group - n_chunks))
    kvg = kv[None].expand(group, *kv.shape).reshape(group * B, *kv.shape[1:])
    geo = vae.geo
    if not torch.is_grad_enabled() or remat == "none":
        fn = geo.query
    elif remat == "full":
        def fn(q, f):
            return checkpoint(geo.query, q, f, use_reentrant=False)
    else:
        def fn(q, f):
            return checkpoint(geo.query_tail, *geo.query_head(q, f), use_reentrant=False)
    out = [fn(qc[g0:g0 + group].reshape(group * B, chunk, 3), kvg).reshape(group, B, chunk)
           for g0 in range(0, n_groups * group, group)]
    logits = torch.cat(out).transpose(0, 1).reshape(B, -1)
    return logits[:, :N]


def vae_query_logits(
    vae: ShapeVAE,
    latents: torch.Tensor,     # [B, L, E]
    queries: torch.Tensor,     # [B, N, 3]
    chunk: int = 8192,
    group: int = 4,
    remat: str = "none",
) -> torch.Tensor:
    """Scaled decode + chunked dense grid query. Returns raw logits [B, N]
    float32 (callers negate to get inside < 0). Differentiable with respect to
    the latents; see ``_geo_query_grouped`` for ``group`` and ``remat``.
    """
    kv = vae_decode_kv(vae, latents)
    return _geo_query_grouped(vae, kv, queries, chunk, group, remat)


# ---------------------------------------------------------------------------
# two-level in-loop decode
# ---------------------------------------------------------------------------

def _upsample_corner_aligned(g: torch.Tensor, cf: int) -> torch.Tensor:
    """Corner-aligned trilinear upsample [..., n_c, n_c, n_c] -> [...,
    (n_c-1)*cf+1, ...]^3 (of each image of a batch). The in-loop decode's
    background values feed differentiable SDF losses, so they interpolate."""

    def up_axis(a):   # along the third axis from the end
        base, nxt = a[..., :-1, :, :], a[..., 1:, :, :]
        parts = torch.stack([base * (1 - r / cf) + nxt * (r / cf) for r in range(cf)], dim=-3)
        out = parts.reshape(*a.shape[:-3], (a.shape[-3] - 1) * cf, *a.shape[-2:])
        return torch.cat([out, a[..., -1:, :, :]], dim=-3)

    for _ in range(3):
        g = torch.movedim(up_axis(g), -3, -1)
    return g


def _select_surface_cells(g_c3: torch.Tensor, res_c: int, pad_factor: float) -> torch.Tensor:
    """Flat bool [..., res_c^3] mask of the cells whose corner values could
    cross zero within a ``pad_factor`` margin of their spread (g_c3 [...,
    n_c, n_c, n_c], of each image of a batch)."""
    cs = torch.stack([g_c3[..., dx:dx + res_c, dy:dy + res_c, dz:dz + res_c]
                      for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)])
    cmin, cmax = cs.amin(0), cs.amax(0)
    min_abs = torch.minimum(cmin.abs(), cmax.abs())
    spread = cmax - cmin
    select = ((cmin <= 0) & (cmax >= 0)) | (min_abs < pad_factor * spread)
    return select.flatten(-3)


def _noncoarse_offsets(cf: int) -> np.ndarray:
    """The (cf+1)^3 - 8 within-cell fine-lattice offsets that are not
    coarse-aligned corners (those already carry exact level-1 values)."""
    return np.array([(i, j, k)
                     for i in range(cf + 1)
                     for j in range(cf + 1)
                     for k in range(cf + 1)
                     if not (i % cf == 0 and j % cf == 0 and k % cf == 0)], np.int64)


def _refine_point_budget(cf: int) -> int:
    """Refine points per selected cell, with ~12.5 % margin: a cell of a
    surface shell owns ~cf^3 unique non-coarse points (the reference measured
    at most 8.73 per cell at cf=2 on its capacity-sweep fields)."""
    return (9 * cf ** 3) // 8


def _refine_points(cell_ids: torch.Tensor, res_c: int, cf: int, n_f: int) -> torch.Tensor:
    """The non-coarse fine-lattice points of the given cells, as ascending flat
    ids, each once (adjacent cells share their face and edge points)."""
    ci = cell_ids // (res_c * res_c)
    cj = (cell_ids // res_c) % res_c
    ck = cell_ids % res_c
    base = torch.stack([ci, cj, ck], dim=-1) * cf                        # [K,3]
    offs = torch.as_tensor(_noncoarse_offsets(cf), device=cell_ids.device)   # [P,3]
    fine_idx = base[:, None, :] + offs[None]                             # [K,P,3]
    flat_all = (fine_idx[..., 0] * n_f + fine_idx[..., 1]) * n_f + fine_idx[..., 2]
    mark = torch.zeros(n_f ** 3, dtype=torch.bool, device=cell_ids.device)
    mark[flat_all.reshape(-1)] = True
    return mark.nonzero().squeeze(1)


def vae_query_logits_hier_grid_batch(
    vae: ShapeVAE,
    latents: torch.Tensor,            # [B, L, E]
    bbox_min,
    bbox_max,
    resolution: int,
    chunk: int = 8192,
    coarse_factor: int = 2,
    cell_cap: int = 10240,
    pad_factor: float = 0.5,
    remat: str = "none",
    small_cell_cap: Optional[int] = None,
    group: int = 4,
) -> Tuple[torch.Tensor, List[int]]:
    """Differentiable two-level grid decode of B images at once -> (dense
    logits [B, (res+1)^3], each image's capacity indicator).

    The loss gradient reaches the logits only at surface-crossing cells, so:
    decode the coarse lattice at ``res/cf`` (an exact subset of the fine
    grid), select cells whose corners could cross zero within a
    ``pad_factor`` margin (under ``detach``: the selection is discrete), and
    query only the non-coarse fine points of the selected cells, each point
    once. Each image's cells are truncated at ``cell_cap`` in ascending id
    order and its refine points at ``9*cf^3/8 * cell_cap`` in ascending order;
    what is missed keeps the trilinearly interpolated background.

    The fine values are composed onto the upsampled background by a
    delta/multiplicity scatter-add, so values and gradients equal the dense
    decode's wherever marching tets emits geometry. An image's indicator is
    ``max(n_selected_cells, ceil(n_points / point_cap * cell_cap))``: above
    ``cell_cap`` iff its cells or its points overflowed.

    The coarse lattice and each level's refine points go through one geo
    query for the whole batch: every image's refine points are padded to the
    largest count in the batch with rows at the lattice's point 0 whose delta
    is zeroed, so they add nothing to any value or gradient, and each image's
    grid is the one it gets alone (up to the geo query's sums, which may round
    apart at another batch size). The sizes are read back to the host once,
    for all images. Where the reference pads the refine set with copies of
    point 0 to a static size, this sizes it to the batch; two capacities that
    both fit compose to the same grid, so ``small_cell_cap`` (the reference's
    two-tier capacity) is accepted and has no effect here.
    """
    del small_cell_cap   # sizing to the batch: see the docstring
    if coarse_factor < 2:
        raise ValueError("coarse_factor 1 has an empty refine set; use the dense decode")
    if resolution % coarse_factor:
        raise ValueError(f"resolution {resolution} is not a multiple of {coarse_factor}")
    cf = coarse_factor
    res_c = resolution // cf
    cell_cap = min(cell_cap, res_c ** 3)
    n_c, n_f = res_c + 1, resolution + 1
    n_fine = n_f ** 3
    B = latents.shape[0]
    dev = latents.device
    lo = torch.as_tensor(bbox_min, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(bbox_max, dtype=torch.float32, device=dev)
    step_f = (hi - lo) / resolution

    kv = vae_decode_kv(vae, latents)

    # level 1: the coarse sub-lattice (every cf-th fine point)
    idx_c = torch.arange(n_c, device=dev) * cf
    ijk_c = torch.stack(torch.meshgrid(idx_c, idx_c, idx_c, indexing="ij"), dim=-1)
    pts_c = (lo + ijk_c.float() * step_f).reshape(1, -1, 3).expand(B, -1, -1)
    g_c = _geo_query_grouped(vae, kv, pts_c, chunk, group, remat)
    g_c3 = g_c.reshape(B, n_c, n_c, n_c)

    # the surface cells, discrete and without gradient; each image's first
    # cell_cap of them in ascending id order mark their non-coarse points on
    # the fine lattice (a cell beyond the cap marks the extra column instead)
    select = _select_surface_cells(g_c3.detach(), res_c, pad_factor)     # [B, res_c^3]
    img, cell_ids, rank, n_sel = first_per_image(select, cell_cap)
    ci = cell_ids // (res_c * res_c)
    cj = (cell_ids // res_c) % res_c
    ck = cell_ids % res_c
    base = torch.stack([ci, cj, ck], dim=-1) * cf                        # [K,3]
    offs = torch.as_tensor(_noncoarse_offsets(cf), device=dev)           # [P,3]
    fine = base[:, None, :] + offs[None]                                 # [K,P,3]
    flat = (fine[..., 0] * n_f + fine[..., 1]) * n_f + fine[..., 2]
    flat = torch.where((rank < cell_cap)[:, None], flat, torch.full_like(flat, n_fine))
    mark = torch.zeros((B, n_fine + 1), dtype=torch.bool, device=dev)
    mark[img[:, None].expand_as(flat), flat] = True

    # level 2: each image's marked points, ascending, at most point_cap of them
    point_cap = min(_refine_point_budget(cf) * cell_cap, n_fine)
    # the one host read after the cells' nonzero: both levels' counts
    sizes = torch.stack([n_sel, mark[:, :n_fine].sum(dim=1)]).tolist()
    p_img, p_ids, p_rank, _ = first_per_image(mark[:, :n_fine], point_cap, total=sum(sizes[1]))
    width = min(max(sizes[1]), point_cap) if B else 0
    pt_ids = torch.full((B, width + 1), -1, dtype=torch.long, device=dev)
    pt_ids[p_img, p_rank] = p_ids
    pt_ids = pt_ids[:, :width]
    real = pt_ids >= 0
    pt_ids = pt_ids.clamp(min=0)                                         # padding: point 0
    fijk = torch.stack([pt_ids // (n_f * n_f), (pt_ids // n_f) % n_f, pt_ids % n_f], dim=-1)
    pts_f = lo + fijk.float() * step_f
    g_f = _geo_query_grouped(vae, kv, pts_f, chunk, group, remat)        # [B, width]

    # compose: trilinear background + delta/multiplicity scatter-add. An
    # image's points are distinct, so each float index_add below adds once to
    # a row (and zero where a row pads), and the sum does not depend on the run.
    dense_bg = _upsample_corner_aligned(g_c3, cf).reshape(B, n_fine)
    rows = (pt_ids + image_offsets(B, n_fine, dev)[:, None]).reshape(-1)
    up_at = take_image_rows(dense_bg, pt_ids)
    mult = torch.zeros(B * n_fine, dtype=torch.float32, device=dev).index_add_(
        0, rows, real.reshape(-1).float())
    delta = (g_f - up_at) / take_rows(mult, rows).reshape(B, width).clamp(min=1.0)
    delta = torch.where(real, delta, torch.zeros_like(delta))
    dense = dense_bg.reshape(-1).index_add(0, rows, delta.reshape(-1)).reshape(B, n_fine)

    # points scaled into cell units in float32, as the reference computes it
    indicators = [max(c, int(np.ceil(np.float32(p) / np.float32(point_cap)
                                     * np.float32(cell_cap))))
                  for c, p in zip(*sizes)]
    return dense, indicators


def vae_query_logits_hier_grid(vae: ShapeVAE, latents: torch.Tensor, *args, **kwargs
                               ) -> Tuple[torch.Tensor, int]:
    """``vae_query_logits_hier_grid_batch`` with the batch's worst capacity
    indicator, an int: for latents [1, L, E], that image's."""
    dense, indicators = vae_query_logits_hier_grid_batch(vae, latents, *args, **kwargs)
    return dense, max(indicators)


# ---------------------------------------------------------------------------
# conditioner
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConditionerConfig:
    """DINOv2-G image encoder -> the DiT's condition tokens.

    DINOv2-giant uses the fused SwiGLU FFN; the tiny test config keeps the
    plain MLP. The condition sequence is cls + patches (1,370 tokens at
    518 / 14)."""

    image_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1536
    depth: int = 40
    heads: int = 24
    ffn: str = "swiglu"
    use_cls_token: bool = True
    # the encoder takes the optional mask as a fourth channel (the Flax
    # module infers it from the first call; here it is fixed at construction)
    use_mask: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def n_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + (1 if self.use_cls_token else 0)

    def vit_config(self):
        from followmyhold_tpu_torch.models.vit import ViTConfig

        return ViTConfig(
            img_size=(self.image_size, self.image_size), patch_size=self.patch_size,
            embed_dim=self.embed_dim, depth=self.depth, num_heads=self.heads,
            use_cls_token=True, layerscale_init=1e-5, ffn=self.ffn,
            in_chans=4 if self.use_mask else 3, dtype=self.dtype)


COND_FULL = ConditionerConfig()
COND_TINY = ConditionerConfig(image_size=28, patch_size=14, embed_dim=32, depth=1, heads=2,
                              ffn="mlp", dtype=torch.float32)

_IMAGE_MEAN = (0.485, 0.456, 0.406)
_IMAGE_STD = (0.229, 0.224, 0.225)


class ImageConditioner(nn.Module):
    """image [B,H,W,3] in [0,1] (+ an optional mask channel) -> {'main': tokens}.

    Normalised first, then resized to the encoder's square input with the
    reference's ``jax.image.resize`` cubic semantics (``ops/image.py``)."""

    def __init__(self, cfg: ConditionerConfig, device=None):
        super().__init__()
        from followmyhold_tpu_torch.models.vit import ViT

        self.cfg = cfg
        self.encoder = ViT(cfg.vit_config(), device)

    def forward(self, image: torch.Tensor, mask: Optional[torch.Tensor] = None) -> dict:
        from followmyhold_tpu_torch.ops.image import resize_cubic

        c = self.cfg
        x = image.float()
        if mask is not None:
            x = torch.cat([x, mask.float()[..., None]], dim=-1)
        extra = [0.5] if mask is not None else []
        mean = torch.tensor(list(_IMAGE_MEAN) + extra, dtype=torch.float32, device=x.device)
        std = torch.tensor(list(_IMAGE_STD) + extra, dtype=torch.float32, device=x.device)
        x = (x - mean) / std
        if x.shape[1] != c.image_size:
            x = resize_cubic(x, c.image_size, c.image_size)
        return {"main": self.encoder(x, keep_prefix=c.use_cls_token)}


class Conditioner(nn.Module):
    """The image encoder and the unconditional embedding. The latter is zeros
    in the original model; it is a zero-initialised parameter here, as in the
    reference, so that a checkpoint that ships a learned table converts onto
    it."""

    def __init__(self, cfg: ConditionerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = ImageConditioner(cfg, device)
        self.uncond_embedding = nn.Parameter(torch.zeros(
            (1, cfg.n_tokens, cfg.embed_dim), dtype=torch.float32, device=device))

    def forward(self, image: torch.Tensor, mask: Optional[torch.Tensor] = None) -> dict:
        return self.encoder(image, mask)

    def unconditional_embedding(self, bsz: int) -> dict:
        return {"main": self.uncond_embedding.expand(bsz, -1, -1)}


# ---------------------------------------------------------------------------
# two-level export decode (384^3)
# ---------------------------------------------------------------------------

# exactness needs n_selected <= cap; hierarchical_export_logits warns above it
EXPORT_CELL_CAP = 65536


def _linspace_f32(lo: float, hi: float, n: int) -> np.ndarray:
    """``jnp.linspace(lo, hi, n)`` in float32 as JAX computes it:
    lo * (1 - t) + hi * t with t = i / (n - 1), then the exact endpoint."""
    lo, hi = np.float32(lo), np.float32(hi)
    t = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
    return np.concatenate([lo * (np.float32(1.0) - t) + hi * t, [hi]]).astype(np.float32)


def _refine_point_ids_device(g_c: torch.Tensor, resolution: int, coarse_factor: int,
                             cell_cap: int, pad_factor: float) -> Tuple[torch.Tensor, int, int]:
    """The export's refine points, computed where ``g_c`` lies: the ascending,
    deduplicated fine-lattice ids of the selected cells' non-coarse points,
    with the reference's static capacities: cells beyond ``cell_cap`` (in
    ascending id order) and points beyond ``_refine_point_budget(cf) *
    cell_cap`` are dropped. Where the reference pads both arrays to their caps,
    the ids here are sized exactly; with no cell selected, cell 0's points
    stand in, as the reference's padding rows make them.
    -> (pt_ids, n_selected, n_points)."""
    res_c = resolution // coarse_factor
    n_f = resolution + 1
    cell_ids = _select_surface_cells(g_c, res_c, pad_factor).nonzero().squeeze(1)
    n_sel = cell_ids.numel()
    if n_sel == 0:
        cell_ids = torch.zeros(1, dtype=torch.long, device=g_c.device)
    pt_ids = _refine_points(cell_ids[:cell_cap], res_c, coarse_factor, n_f)
    point_cap = min(_refine_point_budget(coarse_factor) * cell_cap, n_f ** 3)
    return pt_ids[:point_cap], n_sel, pt_ids.numel()


def refine_point_ids_host(g_c, resolution: int, coarse_factor: int = 4,
                          cell_cap: int = EXPORT_CELL_CAP,
                          pad_factor: float = 0.5) -> np.ndarray:
    """The host twin of the device's refine ids: the same computation on the
    CPU from the same coarse values. The selection's float32 operations
    (slices, min, max, abs, one multiply, compares) are exact, so the ids are
    the device's bit for bit."""
    g_c = torch.from_numpy(np.ascontiguousarray(g_c, np.float32))
    return _refine_point_ids_device(g_c, resolution, coarse_factor, cell_cap,
                                    pad_factor)[0].numpy()


def refine_ids_digest(pt_ids) -> int:
    """Order-invariant digest of refine-point ids: their uint32 wrap-around sum.
    Id 0 is coarse-aligned, never a refine point, so a zero-padded id array
    and its valid prefix digest the same."""
    if isinstance(pt_ids, torch.Tensor):
        pt_ids = pt_ids.cpu().numpy()
    return int(np.asarray(pt_ids).astype(np.uint32).sum(dtype=np.uint32))


@torch.no_grad()
def vae_query_logits_hierarchical(
    vae: ShapeVAE,
    latents: torch.Tensor,            # [1, L, E]
    bbox_min,
    bbox_max,
    resolution: int,
    chunk: int = 8192,
    coarse_factor: int = 4,
    cell_cap: int = EXPORT_CELL_CAP,
    pad_factor: float = 0.5,
):
    """The export's two-level decode, device part: decode the coarse lattice
    (res / cf per axis), select the cells whose corners could cross zero
    within ``pad_factor`` of their spread, and decode only those cells'
    non-coarse fine points, each once.

    Returns (coarse grid [n_c,n_c,n_c], refine ids [n], refine values [n],
    n_selected, n_points), n = min(n_points, point cap), on the device.
    ``compose_hierarchical_grid`` builds the dense-equivalent grid on the host.
    """
    if resolution % coarse_factor:
        raise ValueError(f"resolution {resolution} is not a multiple of {coarse_factor}")
    if latents.shape[0] != 1:
        raise ValueError("the export decode is per image: latents must be [1, L, E]")
    dev = latents.device
    n_c = resolution // coarse_factor + 1
    n_f = resolution + 1
    lo = np.asarray(bbox_min, np.float32)
    hi = np.asarray(bbox_max, np.float32)
    step_f = torch.from_numpy((hi - lo) / np.float32(resolution)).to(dev)

    # level 1: the coarse lattice, with the reference's linspace
    axes = [_linspace_f32(lo[d], hi[d], n_c) for d in range(3)]
    pts_c = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(1, -1, 3)
    kv = vae_decode_kv(vae, latents)            # once for both levels
    g_c = _geo_query_grouped(vae, kv, torch.from_numpy(pts_c).to(dev), chunk)[0]
    g_c = g_c.reshape(n_c, n_c, n_c)

    # level 2: the selected cells' deduplicated refine points
    pt_ids, n_sel, n_pts = _refine_point_ids_device(g_c, resolution, coarse_factor, cell_cap,
                                                    pad_factor)
    fijk = torch.stack([pt_ids // (n_f * n_f), (pt_ids // n_f) % n_f, pt_ids % n_f], dim=-1)
    pts_f = torch.from_numpy(lo).to(dev) + fijk.float() * step_f
    g_f = _geo_query_grouped(vae, kv, pts_f[None], chunk)[0]
    return g_c, pt_ids, g_f, n_sel, n_pts


def compose_hierarchical_grid(g_c, refine_vals, resolution: int, coarse_factor: int = 4,
                              cell_cap: int = EXPORT_CELL_CAP, pad_factor: float = 0.5,
                              expect_n_pts=None, pt_ids=None,
                              expect_ids_digest=None) -> np.ndarray:
    """The export's two-level decode, host part: each fine point takes its
    coarse cell's lower-corner value (a floor fill), and the refined points
    are overwritten with their exact values. Every zero-crossing fine cell
    lies in a selected coarse cell, so marching tets emits what it emits on
    the dense decode (given n_selected <= cell_cap).

    ``pt_ids`` are the device's refine ids. Without them the host recomputes
    the ids from ``g_c`` (``refine_point_ids_host``; ``cell_cap`` and
    ``pad_factor`` must be the device call's); ``expect_n_pts`` and
    ``expect_ids_digest`` then check that the two selections agree."""
    g_c = np.asarray(g_c, np.float32)
    refine_vals = np.asarray(refine_vals, np.float32)
    cf = coarse_factor
    n_f = resolution + 1
    idx = np.arange(n_f) // cf
    dense = g_c[idx][:, idx][:, :, idx].reshape(-1)
    if pt_ids is not None:
        pt_ids = np.asarray(pt_ids)
        k = pt_ids.size if expect_n_pts is None else min(pt_ids.size, int(expect_n_pts))
        dense[pt_ids[:k]] = refine_vals[:k]
        return dense

    host_ids = refine_point_ids_host(g_c, resolution, cf, cell_cap, pad_factor)
    if expect_n_pts is not None:
        point_cap = min(_refine_point_budget(cf) * cell_cap, n_f ** 3)
        if min(int(expect_n_pts), point_cap) != host_ids.size:
            raise RuntimeError(
                f"hierarchical compose: the host recomputed {host_ids.size} refine points "
                f"but the device queried {min(int(expect_n_pts), point_cap)}: the selections "
                f"diverged; refusing to scatter misaligned values")
    if expect_ids_digest is not None and refine_ids_digest(host_ids) != int(expect_ids_digest):
        raise RuntimeError(
            f"hierarchical compose: host refine-id digest {refine_ids_digest(host_ids)} != "
            f"device digest {int(expect_ids_digest)}: the selections diverged with the same "
            f"count; refusing to scatter misaligned values")
    dense[host_ids] = refine_vals[: host_ids.size]
    return dense


# set once FOHO_EXPORT_F16 has been reported in this process
_EXPORT_F16_WARNED = False


def _warn_export_f16() -> None:
    """Warn once that ``FOHO_EXPORT_F16=1`` is ignored. The reference then
    ships the export's values as float16, to halve a device-to-host copy over
    a remote-TPU link; the port keeps them in exact float32."""
    global _EXPORT_F16_WARNED
    if os.environ.get("FOHO_EXPORT_F16", "0") == "1" and not _EXPORT_F16_WARNED:
        _EXPORT_F16_WARNED = True
        warnings.warn("FOHO_EXPORT_F16=1 is ignored: the port keeps the export's values in "
                      "exact float32", stacklevel=3)


def hierarchical_export_logits(vae: ShapeVAE, latents: torch.Tensor, box_v: float,
                               resolution: int, chunk: int = 8192,
                               cell_cap: int = EXPORT_CELL_CAP,
                               coarse_factor: int = 4) -> np.ndarray:
    """Device two-level decode, copy to the host, host compose, with the
    reference's capacity warning: the dense [(res+1)^3] float32 logits grid
    (callers negate it for the SDF). ``FOHO_EXPORT_F16=1`` is ignored, with
    one warning."""
    _warn_export_f16()
    g_c, pt_ids, fine, n_sel, n_pts = vae_query_logits_hierarchical(
        vae, latents, [-box_v] * 3, [box_v] * 3, resolution, chunk=chunk,
        coarse_factor=coarse_factor, cell_cap=cell_cap)
    grid = compose_hierarchical_grid(g_c.cpu().numpy(), fine.cpu().numpy(), resolution,
                                     coarse_factor=coarse_factor, cell_cap=cell_cap,
                                     expect_n_pts=n_pts, pt_ids=pt_ids.cpu().numpy())
    pt_cap = min(_refine_point_budget(coarse_factor) * cell_cap, (resolution + 1) ** 3)
    if n_sel > cell_cap or n_pts > pt_cap:
        print(f"WARNING: hierarchical decode capacity overflow: {n_sel}/{cell_cap} surface "
              f"cells, {n_pts}/{pt_cap} refine points — raise cell_cap")
    return grid
