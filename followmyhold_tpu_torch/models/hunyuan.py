"""Hunyuan3D-2 shape-generation stack in PyTorch: flow-matching DiT and
ShapeVAE decoder (forward half).

Counterpart of followmyhold_tpu/models/hunyuan.py. Module and parameter names
follow the Flax modules, so ``utils.params.flax_to_torch`` can load a Flax
parameter tree mechanically; the scan-stacked blocks of the reference are one
module per layer here.

Numerics kept from the reference: LayerNorm and RMSNorm run in float32 with
epsilon 1e-6 and cast back to the block's type; most DiT LayerNorms have no
scale or bias; QK-RMSNorm is per head; GELU is tanh-approximate in the DiT and
exact in the VAE; ``final_proj`` and the geo ``logit`` head are float32; the
joint sequence is condition tokens first, then latents.

The image conditioner, the two-level decode and the differentiable decode with
its rematerialisation knobs are not ported yet; the decode here runs under
``torch.no_grad``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from followmyhold_tpu_torch.ops.attention import multi_head_attention

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

    def __init__(self, dim: int, affine: bool, out_dtype: torch.dtype, device=None):
        super().__init__()
        self.dim = dim
        self.out_dtype = out_dtype
        if affine:
            self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
            self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))
        else:
            self.weight = None
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (self.dim,), self.weight, self.bias, _NORM_EPS)
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
        for block in self.blocks:
            x = block(x)
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

    def query(self, queries: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """queries [B,N,3] x kv [B,L,2*width] -> logits [B,N] float32."""
        c = self.cfg
        q = self.query_in(fourier_embed(queries, c.fourier_freqs).to(c.dtype))
        k, v = kv.chunk(2, dim=-1)
        qh = _split_heads(self.q(self.lnq(q)), c.geo_heads)
        attn = _attention(qh, _split_heads(k, c.geo_heads), _split_heads(v, c.geo_heads))
        x = q + self.proj(_merge_heads(attn))
        x = x + self.fc2(F.gelu(self.fc1(self.ln3(x))))
        return self.logit(self.ln_out(x))[..., 0]

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


@torch.no_grad()
def vae_query_logits(
    vae: ShapeVAE,
    latents: torch.Tensor,     # [B, L, E]
    queries: torch.Tensor,     # [B, N, 3]
    chunk: int = 8192,
    group: int = 4,
) -> torch.Tensor:
    """Scaled decode + chunked dense grid query. Returns raw logits [B, N]
    float32 (callers negate to get inside < 0).

    ``group`` chunks are stacked on the batch axis per call, so one attention
    launch covers group x chunk query points against the shared k/v. Runs
    without autograd: the differentiable decode is not ported yet.
    """
    kv = vae_decode_kv(vae, latents)
    B, N, _ = queries.shape
    pad = (-N) % chunk
    qp = F.pad(queries, (0, 0, 0, pad))
    qc = qp.reshape(B, -1, chunk, 3).transpose(0, 1)            # [n_chunks,B,chunk,3]
    out = []
    for g0 in range(0, qc.shape[0], group):
        qg = qc[g0:g0 + group]                                  # [G,B,chunk,3]
        G = qg.shape[0]
        kvg = kv[None].expand(G, *kv.shape).reshape(G * B, *kv.shape[1:])
        logits = vae.geo.query(qg.reshape(G * B, chunk, 3), kvg)
        out.append(logits.reshape(G, B, chunk))
    logits = torch.cat(out).transpose(0, 1).reshape(B, -1)
    return logits[:, :N]
