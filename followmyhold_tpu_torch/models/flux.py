"""FLUX.1 (Kontext) rectified-flow image editor in PyTorch.

Counterpart of followmyhold_tpu/models/flux.py (the diffusers graphs of
FluxTransformer2DModel and the FLUX AutoencoderKL):

- ``FluxTransformer``: 19 double-stream and 38 single-stream blocks at width
  3072, 24 heads of 128, 3-axis RoPE (16/56/56) on interleaved (even, odd)
  pairs, adaLN-zero modulation from (timestep, guidance, pooled CLIP), T5
  sequence conditioning. Every block's attention prologue (the QK RMS-norms,
  RoPE, and the joint [txt, img] q, k and v) goes through
  ``ops.rope.qk_norm_rope`` (on the card csrc/qk_norm_rope.cu, one launch a
  stream: 76 a step), and its joint attention through
  ``ops.attention.multi_head_attention``: at a 512^2 crop (1,024 noisy
  tokens, 1,024 context tokens, 512 T5 tokens) the flash-attention kernel
  (csrc/flash_attention_fwd.cu) runs at [1, 24, 2560, 128], 57 times a step.
- ``FluxVae``: the 16-channel AutoencoderKL (no quant convs), its mid-block
  attention a plain single-head product as in the reference; every GroupNorm
  through ``ops.norms.group_norm_f32`` (float32, epsilon 1e-6).
- ``pack_latents`` / ``unpack_latents`` / ``latent_ids`` and ``kontext_edit``,
  the FluxKontextPipeline's sampling: Kontext conditions on the source image
  by concatenating its packed latents to the noisy ones, with ids whose first
  RoPE axis is 1; 28 flow-matching Euler steps in float32 latents with the
  dev model's time shift and guidance embedding (no CFG batch).

Module and parameter names follow the Flax modules (``double{i}``,
``single{i}``, ``norm_q``, ``x_embedder``, ``timestep_embedder/linear_1``,
``enc/down{b}_res{l}``, ``dec/mid_attn``, ...), so
``utils.params.flax_to_torch`` loads a Flax tree. Precision as in the
reference: weights and matmuls in the model's type (bf16 at full size),
LayerNorms, QK-norms, RoPE and GroupNorms in float32 and cast back, the
transformer's ``proj_out`` and the VAE's ``conv_out`` in float32. Images and
latents enter and leave channels-last, as in the reference; inside the VAE,
maps are NCHW for torch's convolutions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from followmyhold_tpu_torch.models.hunyuan import _merge_heads
from followmyhold_tpu_torch.ops.attention import multi_head_attention
from followmyhold_tpu_torch.ops.norms import group_norm_f32
from followmyhold_tpu_torch.ops.rope import qk_norm_rope
from followmyhold_tpu_torch.utils.profiling import anchor, span

_LN_EPS = 1e-6


# --------------------------------------------------------------------------- #
# transformer
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64              # 16 latent ch x 2x2 packing
    hidden: int = 3072
    heads: int = 24
    num_layers: int = 19
    num_single_layers: int = 38
    joint_dim: int = 4096              # T5 hidden
    pooled_dim: int = 768              # CLIP hidden
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    guidance_embeds: bool = True
    mlp_ratio: float = 4.0
    dtype: torch.dtype = torch.bfloat16


FLUX_DEV = FluxConfig()
FLUX_TINY_TEST = FluxConfig(in_channels=16, hidden=48, heads=3, num_layers=1,
                            num_single_layers=2, joint_dim=32, pooled_dim=24,
                            axes_dims_rope=(4, 6, 6), dtype=torch.float32)


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers Timesteps(flip_sin_to_cos=True, shift=0): cat(cos, sin), float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def rope_freqs(ids: torch.Tensor, axes_dims: Sequence[int], theta: float = 10000.0):
    """ids [..., n_axes] -> (cos, sin), each [..., head_dim // 2] float32, for
    the pairwise rotation (diffusers FluxPosEmbed): each axis' frequencies
    side by side."""
    cos, sin = [], []
    for i, d in enumerate(axes_dims):
        omega = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=ids.device) / d)
        ang = ids[..., i:i + 1].float() * omega[None]
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, dim=-1), torch.cat(sin, dim=-1)


def _layer_norm(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm without scale or bias, in float32, cast to ``dtype``."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=_LN_EPS).to(dtype)


def _attention(q, k, v):
    return multi_head_attention(q, k, v, device=q.device)


def _linear(n_in: int, n_out: int, dtype, device) -> nn.Linear:
    return nn.Linear(n_in, n_out, dtype=dtype, device=device)


class MlpEmbed(nn.Module):
    def __init__(self, n_in: int, hidden: int, dtype, device=None):
        super().__init__()
        self.linear_1 = _linear(n_in, hidden, dtype, device)
        self.linear_2 = _linear(hidden, hidden, dtype, device)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class QKNorm(nn.Module):
    """The learned scale of a per-head RMSNorm (diffusers qk_norm='rms_norm'),
    which the blocks hand to ``ops.rope.qk_norm_rope``; a module, so the
    parameter keeps its checkpoint name (``norm_q.weight``, ...)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))


class FluxDoubleBlock(nn.Module):
    """The image and text streams, each with its own modulation, projections
    and MLP, attending jointly over [txt, img]."""

    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        h, hd, dt = c.hidden, c.hidden // c.heads, c.dtype
        mlp = int(h * c.mlp_ratio)
        self.norm1_linear = _linear(h, 6 * h, dt, device)
        self.norm1_context_linear = _linear(h, 6 * h, dt, device)
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
                     "to_out", "to_add_out"):
            setattr(self, name, _linear(h, h, dt, device))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(self, name, QKNorm(hd, device))
        self.ff_in = _linear(h, mlp, dt, device)
        self.ff_out = _linear(mlp, h, dt, device)
        self.ff_context_in = _linear(h, mlp, dt, device)
        self.ff_context_out = _linear(mlp, h, dt, device)

    def forward(self, img, txt, vec, cos, sin):
        c = self.cfg
        im = self.norm1_linear(F.silu(vec))[:, None].chunk(6, dim=-1)
        tm = self.norm1_context_linear(F.silu(vec))[:, None].chunk(6, dim=-1)
        xin = _layer_norm(img, c.dtype) * (1 + im[1]) + im[0]
        tin = _layer_norm(txt, c.dtype) * (1 + tm[1]) + tm[0]

        img_stream = (self.to_q(xin), self.to_k(xin), self.to_v(xin),
                      self.norm_q.weight, self.norm_k.weight)
        txt_stream = (self.add_q_proj(tin), self.add_k_proj(tin), self.add_v_proj(tin),
                      self.norm_added_q.weight, self.norm_added_k.weight)
        q, k, v = qk_norm_rope([txt_stream, img_stream], cos, sin, c.heads)
        attn = _merge_heads(_attention(q, k, v))
        n_txt = txt.shape[1]
        t_attn, x_attn = attn[:, :n_txt], attn[:, n_txt:]

        img = img + im[2] * self.to_out(x_attn)
        txt = txt + tm[2] * self.to_add_out(t_attn)

        xin = _layer_norm(img, c.dtype) * (1 + im[4]) + im[3]
        img = img + im[5] * self.ff_out(F.gelu(self.ff_in(xin), approximate="tanh"))
        tin = _layer_norm(txt, c.dtype) * (1 + tm[4]) + tm[3]
        txt = txt + tm[5] * self.ff_context_out(
            F.gelu(self.ff_context_in(tin), approximate="tanh"))
        return img, txt


class FluxSingleBlock(nn.Module):
    """One stream over [txt, img]: attention and MLP side by side, one output
    projection."""

    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        h, hd, dt = c.hidden, c.hidden // c.heads, c.dtype
        mlp = int(h * c.mlp_ratio)
        self.norm_linear = _linear(h, 3 * h, dt, device)
        self.to_q = _linear(h, h, dt, device)
        self.to_k = _linear(h, h, dt, device)
        self.to_v = _linear(h, h, dt, device)
        self.norm_q = QKNorm(hd, device)
        self.norm_k = QKNorm(hd, device)
        self.proj_mlp = _linear(h, mlp, dt, device)
        self.proj_out = _linear(h + mlp, h, dt, device)

    def forward(self, x, vec, cos, sin):
        c = self.cfg
        shift, scale, gate = self.norm_linear(F.silu(vec))[:, None].chunk(3, dim=-1)
        xin = _layer_norm(x, c.dtype) * (1 + scale) + shift
        q, k, v = qk_norm_rope([(self.to_q(xin), self.to_k(xin), self.to_v(xin),
                                 self.norm_q.weight, self.norm_k.weight)], cos, sin, c.heads)
        attn = _merge_heads(_attention(q, k, v))
        mlp = F.gelu(self.proj_mlp(xin), approximate="tanh")
        return x + gate * self.proj_out(torch.cat([attn, mlp], dim=-1))


class FluxTransformer(nn.Module):
    """The velocity [B, N_img(+N_ctx), in_channels] float32 of the packed latents."""

    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.x_embedder = _linear(c.in_channels, c.hidden, c.dtype, device)
        self.context_embedder = _linear(c.joint_dim, c.hidden, c.dtype, device)
        self.timestep_embedder = MlpEmbed(256, c.hidden, c.dtype, device)
        if c.guidance_embeds:
            self.guidance_embedder = MlpEmbed(256, c.hidden, c.dtype, device)
        self.text_embedder = MlpEmbed(c.pooled_dim, c.hidden, c.dtype, device)
        for i in range(c.num_layers):
            self.add_module(f"double{i}", FluxDoubleBlock(c, device))
        for i in range(c.num_single_layers):
            self.add_module(f"single{i}", FluxSingleBlock(c, device))
        self.norm_out_linear = _linear(c.hidden, 2 * c.hidden, c.dtype, device)
        self.proj_out = _linear(c.hidden, c.in_channels, torch.float32, device)

    def forward(
        self,
        hidden_states: torch.Tensor,          # [B, N_img(+N_ctx), in_channels]
        encoder_hidden_states: torch.Tensor,  # [B, T, joint_dim]
        pooled: torch.Tensor,                 # [B, pooled_dim]
        timestep: torch.Tensor,               # [B] in [0, 1]
        img_ids: torch.Tensor,                # [N_img(+N_ctx), 3]
        txt_ids: torch.Tensor,                # [T, 3]
        guidance: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        c = self.cfg
        img = self.x_embedder(hidden_states.to(c.dtype))
        txt = self.context_embedder(encoder_hidden_states.to(c.dtype))
        vec = self.timestep_embedder(sinusoidal_embedding(timestep * 1000.0, 256).to(c.dtype))
        if c.guidance_embeds:
            g = torch.zeros_like(timestep) if guidance is None else guidance
            vec = vec + self.guidance_embedder(sinusoidal_embedding(g * 1000.0, 256).to(c.dtype))
        vec = vec + self.text_embedder(pooled.to(c.dtype))

        cos, sin = rope_freqs(torch.cat([txt_ids, img_ids], dim=0), c.axes_dims_rope)
        for i in range(c.num_layers):
            img, txt = getattr(self, f"double{i}")(img, txt, vec, cos, sin)
        x = torch.cat([txt, img], dim=1)
        for i in range(c.num_single_layers):
            x = getattr(self, f"single{i}")(x, vec, cos, sin)
        x = x[:, txt.shape[1]:]

        scale, shift = self.norm_out_linear(F.silu(vec))[:, None].chunk(2, dim=-1)
        x = _layer_norm(x, c.dtype) * (1 + scale) + shift
        return self.proj_out(x.float())


# --------------------------------------------------------------------------- #
# VAE (AutoencoderKL, FLUX variant: 16 latent channels)
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class FluxVaeConfig:
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    dtype: torch.dtype = torch.bfloat16


FLUX_VAE = FluxVaeConfig()
FLUX_VAE_TINY = FluxVaeConfig(latent_channels=4,
                              block_out_channels=(8, 16), layers_per_block=1,
                              dtype=torch.float32)


def _group_norm(channels: int, device) -> nn.GroupNorm:
    """Float32 parameters; applied through ``group_norm_f32``."""
    return nn.GroupNorm(min(32, channels), channels, device=device)


def _conv3(n_in: int, n_out: int, dtype, device, stride: int = 1) -> nn.Conv2d:
    """3x3: 'SAME' at stride 1; at stride 2 the caller pads bottom/right."""
    return nn.Conv2d(n_in, n_out, 3, stride=stride, padding=1 if stride == 1 else 0,
                     dtype=dtype, device=device)


class VaeResnet(nn.Module):
    def __init__(self, in_ch: int, ch: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = _group_norm(in_ch, device)
        self.conv1 = _conv3(in_ch, ch, dtype, device)
        self.norm2 = _group_norm(ch, device)
        self.conv2 = _conv3(ch, ch, dtype, device)
        self.conv_shortcut = (nn.Conv2d(in_ch, ch, 1, dtype=dtype, device=device)
                              if in_ch != ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(group_norm_f32(x, self.norm1)).to(self.dtype))
        h = self.conv2(F.silu(group_norm_f32(h, self.norm2)).to(self.dtype))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VaeAttention(nn.Module):
    """Single-head self-attention over the map's pixels: a plain product
    (float32 logits divided by sqrt(C), as in the reference)."""

    def __init__(self, channels: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.group_norm = _group_norm(channels, device)
        for name in ("to_q", "to_k", "to_v", "to_out"):
            setattr(self, name, nn.Linear(channels, channels, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = group_norm_f32(x, self.group_norm).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = h.to(self.dtype)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(C)
        probs = torch.softmax(logits, dim=-1).to(self.dtype)
        o = self.to_out(torch.matmul(probs, v))
        return x + o.reshape(B, H, W, C).permute(0, 3, 1, 2)


class VaeEncoder(nn.Module):
    """NCHW image -> NCHW moments (mean and log-variance), float32."""

    def __init__(self, cfg: FluxVaeConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        chans = c.block_out_channels
        self.conv_in = _conv3(3, chans[0], c.dtype, device)
        prev = chans[0]
        for bi, ch in enumerate(chans):
            for li in range(c.layers_per_block):
                self.add_module(f"down{bi}_res{li}", VaeResnet(prev, ch, c.dtype, device))
                prev = ch
            if bi < len(chans) - 1:
                self.add_module(f"down{bi}_conv", _conv3(ch, ch, c.dtype, device, stride=2))
        self.mid_res0 = VaeResnet(prev, prev, c.dtype, device)
        self.mid_attn = VaeAttention(prev, c.dtype, device)
        self.mid_res1 = VaeResnet(prev, prev, c.dtype, device)
        self.conv_norm_out = _group_norm(prev, device)
        self.conv_out = _conv3(prev, 2 * c.latent_channels, torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.conv_in(x.to(c.dtype))
        for bi in range(len(c.block_out_channels)):
            for li in range(c.layers_per_block):
                x = getattr(self, f"down{bi}_res{li}")(x)
            if bi < len(c.block_out_channels) - 1:
                # pad bottom/right by one, then a VALID stride-2 conv
                x = getattr(self, f"down{bi}_conv")(F.pad(x, (0, 1, 0, 1)))
        x = self.mid_res1(self.mid_attn(self.mid_res0(x)))
        x = F.silu(group_norm_f32(x, self.conv_norm_out)).to(c.dtype)
        return self.conv_out(x.float())


class VaeDecoder(nn.Module):
    """NCHW latents -> NCHW image in [-1, 1] (unclipped), float32."""

    def __init__(self, cfg: FluxVaeConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        rev = tuple(reversed(c.block_out_channels))
        self.conv_in = _conv3(c.latent_channels, rev[0], c.dtype, device)
        self.mid_res0 = VaeResnet(rev[0], rev[0], c.dtype, device)
        self.mid_attn = VaeAttention(rev[0], c.dtype, device)
        self.mid_res1 = VaeResnet(rev[0], rev[0], c.dtype, device)
        prev = rev[0]
        for bi, ch in enumerate(rev):
            for li in range(c.layers_per_block + 1):
                self.add_module(f"up{bi}_res{li}", VaeResnet(prev, ch, c.dtype, device))
                prev = ch
            if bi < len(rev) - 1:
                self.add_module(f"up{bi}_conv", _conv3(ch, ch, c.dtype, device))
        self.conv_norm_out = _group_norm(prev, device)
        self.conv_out = _conv3(prev, 3, torch.float32, device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.conv_in(z.to(c.dtype))
        x = self.mid_res1(self.mid_attn(self.mid_res0(x)))
        n_levels = len(c.block_out_channels)
        for bi in range(n_levels):
            for li in range(c.layers_per_block + 1):
                x = getattr(self, f"up{bi}_res{li}")(x)
            if bi < n_levels - 1:
                # jax.image.resize(..., "nearest") at exactly 2x repeats each pixel
                x = F.interpolate(x, scale_factor=2, mode="nearest-exact")
                x = getattr(self, f"up{bi}_conv")(x)
        x = F.silu(group_norm_f32(x, self.conv_norm_out)).to(c.dtype)
        return self.conv_out(x.float())


class FluxVae(nn.Module):
    def __init__(self, cfg: FluxVaeConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.enc = VaeEncoder(cfg, device)
        self.dec = VaeDecoder(cfg, device)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(image))

    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """[B,H,W,3] in [-1,1] -> scaled latents [B,H/8,W/8,C] float32 (the
        deterministic mean)."""
        c = self.cfg
        moments = self.enc(image.permute(0, 3, 1, 2))
        mean = moments[:, :c.latent_channels].permute(0, 2, 3, 1)
        return (mean - c.shift_factor) * c.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B,h,w,C] -> [B,8h,8w,3] float32 in about [-1, 1]."""
        c = self.cfg
        x = self.dec((z / c.scaling_factor + c.shift_factor).permute(0, 3, 1, 2))
        return x.permute(0, 2, 3, 1)


# --------------------------------------------------------------------------- #
# packing + Kontext sampling
# --------------------------------------------------------------------------- #

def pack_latents(z: torch.Tensor) -> torch.Tensor:
    """[B, h, w, C] -> [B, (h/2)(w/2), 4C] (2x2 patchify)."""
    B, h, w, C = z.shape
    z = z.reshape(B, h // 2, 2, w // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
    return z.reshape(B, (h // 2) * (w // 2), C * 4)


def unpack_latents(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    B, N, D = tokens.shape
    C = D // 4
    z = tokens.reshape(B, h // 2, w // 2, C, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return z.reshape(B, h, w, C)


def latent_ids(h2: int, w2: int, t: int = 0) -> np.ndarray:
    """Packed-token position ids [(h2*w2), 3] = (t, y, x); Kontext context
    tokens use t=1."""
    ids = np.zeros((h2, w2, 3), np.float32)
    ids[..., 0] = t
    ids[..., 1] = np.arange(h2)[:, None]
    ids[..., 2] = np.arange(w2)[None, :]
    return ids.reshape(-1, 3)


def kontext_sigmas(num_steps: int, n_img: int) -> np.ndarray:
    """[num_steps + 1] float32: linspace(1, 1/num_steps) through the dev
    model's exponential time shift, whose mu is interpolated from the image
    sequence length (diffusers calculate_shift: 0.5 at 256 tokens -> 1.15 at
    4096), then 0. The linspace is ``jnp.linspace``'s float32 formula
    (start * (1 - s) + stop * s, s = i / (n - 1)); a compiler that fuses it
    into an FMA may round a value one ulp apart."""
    mu = 0.5 + (n_img - 256) * (1.15 - 0.5) / (4096 - 256)
    f32 = np.float32
    stop = f32(1.0 / num_steps)
    s = (np.arange(num_steps - 1, dtype=f32) / f32(max(num_steps - 1, 1))).astype(f32)
    base = np.concatenate([f32(1.0) * (f32(1) - s) + stop * s, [stop]]).astype(f32)
    e = f32(math.exp(mu))
    shifted = (e / (e + (f32(1.0) / base - f32(1.0)))).astype(f32)
    return np.concatenate([shifted, np.zeros(1, f32)])


def kontext_edit(
    transformer: FluxTransformer,
    vae: FluxVae,
    t5_states: torch.Tensor,       # [1, T, joint_dim]
    pooled: torch.Tensor,          # [1, pooled_dim]
    image_rgb01: torch.Tensor,     # [1, H, W, 3] in [0, 1]
    generator: Optional[torch.Generator] = None,
    num_steps: int = 28,
    guidance: float = 2.5,
    initial_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """FluxKontextPipeline inference: new latents sampled with the packed
    source-image latents (ids t=1) and the prompt as conditions -> [1,H,W,3]
    float32 in [0, 1]. Flow-matching Euler in float32 latents with the dev
    model's guidance embedding (no CFG double batch). The noise is
    ``initial_noise`` (the packed latents' shape), or drawn from
    ``generator``. No host synchronisation inside the loop. Spans
    (``utils.profiling``): ``flux.vae_encode`` (the encode, packing, ids and
    noise), ``flux.step`` for each step (the transformer and the Euler
    update), ``flux.vae_decode`` (unpacking, the decode and the clamp); the
    ids' synchronous copy anchors the call's device clock."""
    dev = image_rgb01.device
    B = image_rgb01.shape[0]
    with span("flux.vae_encode"):
        z_ctx = vae.encode(image_rgb01 * 2.0 - 1.0)
        h, w = z_ctx.shape[1:3]
        ctx_tokens = pack_latents(z_ctx)
        n_img = (h // 2) * (w // 2)

        img_ids = torch.from_numpy(np.concatenate(
            [latent_ids(h // 2, w // 2, 0), latent_ids(h // 2, w // 2, 1)])).to(dev)
        anchor()            # the copy from pageable memory waited for the card's queue
        txt_ids = torch.zeros((t5_states.shape[1], 3), dtype=torch.float32, device=dev)
        if initial_noise is not None:
            lat = (initial_noise if isinstance(initial_noise, torch.Tensor)
                   else torch.from_numpy(np.array(initial_noise, np.float32)))
            lat = lat.to(device=dev, dtype=torch.float32)
            if lat.shape != ctx_tokens.shape:
                raise ValueError(f"initial_noise {tuple(lat.shape)} does not match the packed "
                                 f"latents {tuple(ctx_tokens.shape)}")
        else:
            lat = torch.randn(ctx_tokens.shape, generator=generator, dtype=torch.float32,
                              device=dev)

        sigmas = kontext_sigmas(num_steps, n_img)
        g = torch.full((B,), guidance, dtype=torch.float32, device=dev)
    for i in range(num_steps):
        with span("flux.step"):
            t = torch.full((B,), float(sigmas[i]), dtype=torch.float32, device=dev)
            v = transformer(torch.cat([lat, ctx_tokens], dim=1), t5_states, pooled, t,
                            img_ids, txt_ids, g)[:, :n_img]
            lat = lat + float(sigmas[i + 1] - sigmas[i]) * v
    with span("flux.vae_decode"):
        out = vae.decode(unpack_latents(lat, h, w))
        return torch.clamp(out * 0.5 + 0.5, 0.0, 1.0)
