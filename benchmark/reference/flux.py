"""The plain reference of the configuration ``flux1-kontext-dev``, written from
the published graphs and independent of the program: the FLUX.1 transformer
(black-forest-labs/flux ``flux/model.py`` and ``modules/layers.py``; diffusers
``FluxTransformer2DModel``), the FLUX AutoencoderKL (diffusers
``AutoencoderKL`` with 16 latent channels, no quant convolutions), T5-XXL's
encoder and CLIP-L's text tower (transformers ``T5EncoderModel`` and
``CLIPTextModel``), the FluxKontextPipeline's packing, position ids and sigma
schedule, and the two checkpoint tokenizers (``reference/tokenizers.py``).

Every model is a function of its weights, a dict of float32 tensors by leaf
name. ``layouts`` lists each model's leaves as the benchmark draws them
(``frozen/weights.py``): the checkpoint's tensors under the names the
program's checkpoint files give them, ``[out, in]`` matrices as in torch.
Both sides get the same values: the program's modules by name in their served
types, the reference in float32, a group at a time (a transformer block is
drawn when the forward reaches it and dropped after, since the float32
transformer does not fit beside its activations).

Everything runs in float32 with TF32 off (matrix products and convolutions);
attention is an explicit softmax product. ``control=True`` is the check's
control: every matrix rounded to float8 e4m3 with one scale a matrix, the step
below the bf16 that the configuration serves.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.frozen import weights
from benchmark.reference.tokenizers import ClipBpeTokenizer, UnigramTokenizer

MODELS = ("transformer", "vae", "clip", "t5")
FP8_MAX = 448.0
LN_EPS = 1e-6          # the transformer's LayerNorms and QK RMSNorms
GN_EPS = 1e-6          # the VAE's GroupNorms
GN_GROUPS = 32

Leaf = Tuple[str, Tuple[int, ...], torch.dtype]
W = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------- #
# the leaves the benchmark draws, in their served types
# --------------------------------------------------------------------------- #

def _served(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def _linear(name: str, n_in: int, n_out: int, dtype, bias: bool = True) -> List[Leaf]:
    out = [(f"{name}.weight", (n_out, n_in), dtype)]
    return out + [(f"{name}.bias", (n_out,), dtype)] if bias else out


def _norm(name: str, n: int, bias: bool = True) -> List[Leaf]:
    out = [(f"{name}.weight", (n,), torch.float32)]
    return out + [(f"{name}.bias", (n,), torch.float32)] if bias else out


def _conv(name: str, n_in: int, n_out: int, k: int, dtype) -> List[Leaf]:
    return [(f"{name}.weight", (n_out, n_in, k, k), dtype), (f"{name}.bias", (n_out,), dtype)]


def _transformer_layout(c: dict) -> Dict[str, List[Leaf]]:
    h, dt = c["hidden"], _served(c)
    hd, mlp = h // c["heads"], int(h * c["mlp_ratio"])
    out = {"x_embedder": _linear("x_embedder", c["in_channels"], h, dt),
           "context_embedder": _linear("context_embedder", c["joint_dim"], h, dt)}
    embedders = ["timestep_embedder"] + (["guidance_embedder"] if c["guidance_embeds"] else [])
    for name in embedders:
        out[name] = _linear(f"{name}.linear_1", 256, h, dt) + _linear(f"{name}.linear_2", h, h, dt)
    out["text_embedder"] = (_linear("text_embedder.linear_1", c["pooled_dim"], h, dt)
                            + _linear("text_embedder.linear_2", h, h, dt))
    for i in range(c["num_layers"]):
        p = f"double{i}."
        leaves = _linear(p + "norm1_linear", h, 6 * h, dt)
        leaves += _linear(p + "norm1_context_linear", h, 6 * h, dt)
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
                     "to_out", "to_add_out"):
            leaves += _linear(p + name, h, h, dt)
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            leaves += _norm(p + name, hd, bias=False)
        leaves += _linear(p + "ff_in", h, mlp, dt) + _linear(p + "ff_out", mlp, h, dt)
        leaves += _linear(p + "ff_context_in", h, mlp, dt)
        leaves += _linear(p + "ff_context_out", mlp, h, dt)
        out[f"double{i}"] = leaves
    for i in range(c["num_single_layers"]):
        p = f"single{i}."
        leaves = _linear(p + "norm_linear", h, 3 * h, dt)
        for name in ("to_q", "to_k", "to_v"):
            leaves += _linear(p + name, h, h, dt)
        leaves += _norm(p + "norm_q", hd, bias=False) + _norm(p + "norm_k", hd, bias=False)
        leaves += _linear(p + "proj_mlp", h, mlp, dt) + _linear(p + "proj_out", h + mlp, h, dt)
        out[f"single{i}"] = leaves
    out["norm_out_linear"] = _linear("norm_out_linear", h, 2 * h, dt)
    out["proj_out"] = _linear("proj_out", h, c["in_channels"], torch.float32)
    return out


def _resnet(p: str, n_in: int, n: int, dt) -> List[Leaf]:
    leaves = _norm(p + "norm1", n_in) + _conv(p + "conv1", n_in, n, 3, dt)
    leaves += _norm(p + "norm2", n) + _conv(p + "conv2", n, n, 3, dt)
    return leaves + (_conv(p + "conv_shortcut", n_in, n, 1, dt) if n_in != n else [])


def _vae_attn(p: str, n: int, dt) -> List[Leaf]:
    leaves = _norm(p + "group_norm", n)
    for name in ("to_q", "to_k", "to_v", "to_out"):
        leaves += _linear(p + name, n, n, dt)
    return leaves


def _mid(p: str, n: int, dt) -> List[Leaf]:
    return (_resnet(p + "mid_res0.", n, n, dt) + _vae_attn(p + "mid_attn.", n, dt)
            + _resnet(p + "mid_res1.", n, n, dt))


def _vae_layout(c: dict) -> Dict[str, List[Leaf]]:
    dt, chans, lat = _served(c), list(c["block_out_channels"]), c["latent_channels"]
    enc = _conv("enc.conv_in", 3, chans[0], 3, dt)
    prev = chans[0]
    for b, ch in enumerate(chans):
        for k in range(c["layers_per_block"]):
            enc += _resnet(f"enc.down{b}_res{k}.", prev, ch, dt)
            prev = ch
        if b < len(chans) - 1:
            enc += _conv(f"enc.down{b}_conv", ch, ch, 3, dt)
    enc += _mid("enc.", prev, dt) + _norm("enc.conv_norm_out", prev)
    enc += _conv("enc.conv_out", prev, 2 * lat, 3, torch.float32)
    rev = chans[::-1]
    dec = _conv("dec.conv_in", lat, rev[0], 3, dt) + _mid("dec.", rev[0], dt)
    prev = rev[0]
    for b, ch in enumerate(rev):
        for k in range(c["layers_per_block"] + 1):
            dec += _resnet(f"dec.up{b}_res{k}.", prev, ch, dt)
            prev = ch
        if b < len(rev) - 1:
            dec += _conv(f"dec.up{b}_conv", ch, ch, 3, dt)
    dec += _norm("dec.conv_norm_out", prev) + _conv("dec.conv_out", prev, 3, 3, torch.float32)
    return {"enc": enc, "dec": dec}


def _clip_layout(c: dict) -> Dict[str, List[Leaf]]:
    D, dt = c["hidden_size"], _served(c)
    out = {"position_embedding": [("position_embedding", (c["max_position_embeddings"], D),
                                   torch.float32)],
           "token_embedding": [("token_embedding.weight", (c["vocab_size"], D), torch.float32)]}
    for i in range(c["num_layers"]):
        p = f"layer{i}."
        leaves = _norm(p + "layer_norm1", D)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            leaves += _linear(p + name, D, D, dt)
        leaves += _norm(p + "layer_norm2", D)
        leaves += _linear(p + "fc1", D, c["intermediate_size"], dt)
        leaves += _linear(p + "fc2", c["intermediate_size"], D, dt)
        out[f"layer{i}"] = leaves
    out["final_layer_norm"] = _norm("final_layer_norm", D)
    return out


def _t5_layout(c: dict) -> Dict[str, List[Leaf]]:
    d, dt, inner = c["d_model"], _served(c), c["num_heads"] * c["d_kv"]
    out = {"shared": [("shared.weight", (c["vocab_size"], d), dt)]}
    for i in range(c["num_layers"]):
        p = f"block{i}."
        leaves = _norm(p + "ln1", d, bias=False)
        if i == 0:      # the relative position table: made by block 0, used by every block
            leaves.append((p + "attn.relative_attention_bias",
                           (c["relative_attention_num_buckets"], c["num_heads"]), torch.float32))
        for name in ("q", "k", "v"):
            leaves += _linear(p + "attn." + name, d, inner, dt, bias=False)
        leaves += _linear(p + "attn.o", inner, d, dt, bias=False)
        leaves += _norm(p + "ln2", d, bias=False)
        leaves += _linear(p + "wi_0", d, c["d_ff"], dt, bias=False)
        leaves += _linear(p + "wi_1", d, c["d_ff"], dt, bias=False)
        leaves += _linear(p + "wo", c["d_ff"], d, dt, bias=False)
        out[f"block{i}"] = leaves
    out["final_norm"] = _norm("final_norm", d, bias=False)
    return out


def layouts(config: dict) -> Dict[str, Dict[str, List[Leaf]]]:
    """{model: {group: [(leaf name, shape, served dtype), ...]}}: what the
    benchmark draws for both sides."""
    return {"transformer": _transformer_layout(config["transformer"]),
            "vae": _vae_layout(config["vae"]),
            "clip": _clip_layout(config["clip"]),
            "t5": _t5_layout(config["t5"])}


class Weights:
    """One model's reference weights, drawn a group at a time in float32
    (rounded to float8 for the control)."""

    def __init__(self, config: dict, model: str, seed: int, device, control: bool = False):
        self.layout = layouts(config)[model]
        self.model, self.seed, self.device, self.control = model, seed, device, control

    def group(self, name: str) -> W:
        out = dict(weights.draw_group(self.layout[name], self.seed, self.model, name,
                                      self.device, dtype=torch.float32))
        if self.control:
            for k, v in out.items():
                if v.dim() >= 2:
                    out[k] = _fp8(v)
        return out

    def groups(self, names) -> W:
        out: W = {}
        for name in names:
            out.update(self.group(name))
        return out

    def all(self) -> W:
        return self.groups(self.layout)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@contextlib.contextmanager
def float32_math():
    """TF32 off for matrix products and convolutions inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# --------------------------------------------------------------------------- #
# shared pieces
# --------------------------------------------------------------------------- #

def _lin(w: W, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w[f"{name}.weight"], w.get(f"{name}.bias"))


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, N, H*D] -> [B, H, N, D]."""
    B, N, _ = x.shape
    return x.view(B, N, heads, -1).transpose(1, 2)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    B, H, N, D = x.shape
    return x.transpose(1, 2).reshape(B, N, H * D)


def _softmax_attention(q, k, v, scale: float, bias=None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v, one batch row at a time (the float32
    logits of 24 heads at 2,560 tokens are 0.63 GB a row)."""
    out = []
    for b in range(q.shape[0]):
        logits = torch.matmul(q[b], k[b].transpose(-1, -2)) * scale
        if bias is not None:
            logits = logits + bias[0]
        out.append(torch.matmul(torch.softmax(logits, dim=-1), v[b]))
    return torch.stack(out)


def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * weight


# --------------------------------------------------------------------------- #
# the FLUX.1 transformer
# --------------------------------------------------------------------------- #

def timestep_embedding(t: torch.Tensor, dim: int = 256, max_period: float = 10000.0):
    """flux ``timestep_embedding`` of t already scaled by 1000: cat(cos, sin)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float64,
                                                           device=t.device) / half)
    args = t.double()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).float()


def rope(ids: torch.Tensor, axes_dims, theta: float = 10000.0):
    """(cos, sin) [N, head_dim / 2] of the position ids [N, n_axes]: each
    axis' frequencies side by side (flux ``EmbedND``), angles in float64."""
    cos, sin = [], []
    for i, d in enumerate(axes_dims):
        omega = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=ids.device) / d)
        ang = ids[:, i].double()[:, None] * omega[None]
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, -1).float(), torch.cat(sin, -1).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """flux ``apply_rope``: each (even, odd) pair of the head dimension turned
    by its angle."""
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).flatten(-2)


def _modulation(w: W, name: str, vec: torch.Tensor, n: int):
    return _lin(w, name, F.silu(vec))[:, None].chunk(n, dim=-1)


def _ln(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), eps=LN_EPS)


def _qk(w: W, p: str, x: torch.Tensor, heads: int, q: str, k: str, v: str, nq: str, nk: str):
    return (_rms(_heads(_lin(w, p + q, x), heads), w[p + nq + ".weight"], LN_EPS),
            _rms(_heads(_lin(w, p + k, x), heads), w[p + nk + ".weight"], LN_EPS),
            _heads(_lin(w, p + v, x), heads))


def double_block(w: W, i: int, c: dict, img, txt, vec, cos, sin):
    """flux ``DoubleStreamBlock``: each stream modulated, both attending
    jointly over [txt, img], each with its own output and MLP."""
    p, H = f"double{i}.", c["heads"]
    im = _modulation(w, p + "norm1_linear", vec, 6)
    tm = _modulation(w, p + "norm1_context_linear", vec, 6)
    x = _ln(img) * (1 + im[1]) + im[0]
    t = _ln(txt) * (1 + tm[1]) + tm[0]
    q, k, v = _qk(w, p, x, H, "to_q", "to_k", "to_v", "norm_q", "norm_k")
    tq, tk, tv = _qk(w, p, t, H, "add_q_proj", "add_k_proj", "add_v_proj",
                     "norm_added_q", "norm_added_k")
    q = apply_rope(torch.cat([tq, q], dim=2), cos, sin)
    k = apply_rope(torch.cat([tk, k], dim=2), cos, sin)
    v = torch.cat([tv, v], dim=2)
    attn = _unheads(_softmax_attention(q, k, v, q.shape[-1] ** -0.5))
    n = txt.shape[1]
    img = img + im[2] * _lin(w, p + "to_out", attn[:, n:])
    txt = txt + tm[2] * _lin(w, p + "to_add_out", attn[:, :n])
    gelu = lambda y: F.gelu(y, approximate="tanh")  # noqa: E731
    img = img + im[5] * _lin(w, p + "ff_out", gelu(_lin(w, p + "ff_in",
                                                        _ln(img) * (1 + im[4]) + im[3])))
    txt = txt + tm[5] * _lin(w, p + "ff_context_out", gelu(_lin(
        w, p + "ff_context_in", _ln(txt) * (1 + tm[4]) + tm[3])))
    return img, txt


def single_block(w: W, i: int, c: dict, x, vec, cos, sin):
    """flux ``SingleStreamBlock``: attention and MLP side by side over
    [txt, img], one output projection."""
    p = f"single{i}."
    shift, scale, gate = _modulation(w, p + "norm_linear", vec, 3)
    h = _ln(x) * (1 + scale) + shift
    q, k, v = _qk(w, p, h, c["heads"], "to_q", "to_k", "to_v", "norm_q", "norm_k")
    attn = _unheads(_softmax_attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v,
                                       q.shape[-1] ** -0.5))
    mlp = F.gelu(_lin(w, p + "proj_mlp", h), approximate="tanh")
    return x + gate * _lin(w, p + "proj_out", torch.cat([attn, mlp], dim=-1))


@torch.no_grad()
def transformer(wt: Weights, c: dict, hidden, encoder_states, pooled, t, img_ids, txt_ids,
                guidance) -> torch.Tensor:
    """The velocity [B, N_img(+N_ctx), in_channels] of the packed latents;
    ``t`` and ``guidance`` [B] as the pipeline gives them (sigma, scale)."""
    with float32_math():
        w = wt.groups([g for g in wt.layout if not g.startswith(("double", "single"))])
        img = _lin(w, "x_embedder", hidden.float())
        txt = _lin(w, "context_embedder", encoder_states.float())

        def mlp(name, x):
            return _lin(w, name + ".linear_2", F.silu(_lin(w, name + ".linear_1", x)))

        vec = mlp("timestep_embedder", timestep_embedding(t * 1000.0))
        if c["guidance_embeds"]:
            vec = vec + mlp("guidance_embedder", timestep_embedding(guidance * 1000.0))
        vec = vec + mlp("text_embedder", pooled.float())
        cos, sin = rope(torch.cat([txt_ids, img_ids]), c["axes_dims_rope"])
        for i in range(c["num_layers"]):
            img, txt = double_block(wt.group(f"double{i}"), i, c, img, txt, vec, cos, sin)
        x = torch.cat([txt, img], dim=1)
        for i in range(c["num_single_layers"]):
            x = single_block(wt.group(f"single{i}"), i, c, x, vec, cos, sin)
        x = x[:, txt.shape[1]:]
        # diffusers' AdaLayerNormContinuous: scale first, then shift
        scale, shift = _modulation(w, "norm_out_linear", vec, 2)
        return _lin(w, "proj_out", _ln(x) * (1 + scale) + shift)


# --------------------------------------------------------------------------- #
# the FLUX VAE (AutoencoderKL)
# --------------------------------------------------------------------------- #

def _gn(w: W, name: str, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm of 32 groups (fewer only at the tests' tiny widths)."""
    groups = min(GN_GROUPS, x.shape[1])
    return F.group_norm(x, groups, w[name + ".weight"], w[name + ".bias"], eps=GN_EPS)


def _conv2d(w: W, name: str, x: torch.Tensor, stride: int = 1, padding: int = 1):
    return F.conv2d(x, w[name + ".weight"], w[name + ".bias"], stride=stride, padding=padding)


def _resnet_fwd(w: W, p: str, x: torch.Tensor) -> torch.Tensor:
    h = _conv2d(w, p + "conv1", F.silu(_gn(w, p + "norm1", x)))
    h = _conv2d(w, p + "conv2", F.silu(_gn(w, p + "norm2", h)))
    if p + "conv_shortcut.weight" in w:
        x = _conv2d(w, p + "conv_shortcut", x, padding=0)
    return x + h


def _attn_fwd(w: W, p: str, x: torch.Tensor) -> torch.Tensor:
    """The mid block's one-head attention over the map's pixels."""
    B, C, H, Wd = x.shape
    h = _gn(w, p + "group_norm", x).flatten(2).transpose(1, 2)
    q, k, v = (_lin(w, p + n, h)[:, None] for n in ("to_q", "to_k", "to_v"))
    o = _lin(w, p + "to_out", _softmax_attention(q, k, v, C ** -0.5)[:, 0])
    return x + o.transpose(1, 2).reshape(B, C, H, Wd)


def _mid_fwd(w: W, p: str, x: torch.Tensor) -> torch.Tensor:
    x = _resnet_fwd(w, p + "mid_res0.", x)
    return _resnet_fwd(w, p + "mid_res1.", _attn_fwd(w, p + "mid_attn.", x))


@torch.no_grad()
def vae_encode(w: W, c: dict, image: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] in [-1, 1] -> the scaled latent mean [B, H/8, W/8, C]."""
    with float32_math():
        n = len(c["block_out_channels"])
        x = _conv2d(w, "enc.conv_in", image.float().permute(0, 3, 1, 2))
        for b in range(n):
            for k in range(c["layers_per_block"]):
                x = _resnet_fwd(w, f"enc.down{b}_res{k}.", x)
            if b < n - 1:          # diffusers' Downsample2D(padding=0): pad right and bottom
                x = _conv2d(w, f"enc.down{b}_conv", F.pad(x, (0, 1, 0, 1)), stride=2, padding=0)
        x = _mid_fwd(w, "enc.", x)
        moments = _conv2d(w, "enc.conv_out", F.silu(_gn(w, "enc.conv_norm_out", x)))
        mean = moments[:, :c["latent_channels"]].permute(0, 2, 3, 1)
        return (mean - c["shift_factor"]) * c["scaling_factor"]


@torch.no_grad()
def vae_decode(w: W, c: dict, z: torch.Tensor) -> torch.Tensor:
    """Scaled latents [B, h, w, C] -> the image [B, 8h, 8w, 3], about [-1, 1]."""
    with float32_math():
        n = len(c["block_out_channels"])
        x = (z.float() / c["scaling_factor"] + c["shift_factor"]).permute(0, 3, 1, 2)
        x = _mid_fwd(w, "dec.", _conv2d(w, "dec.conv_in", x))
        for b in range(n):
            for k in range(c["layers_per_block"] + 1):
                x = _resnet_fwd(w, f"dec.up{b}_res{k}.", x)
            if b < n - 1:
                x = _conv2d(w, f"dec.up{b}_conv", F.interpolate(x, scale_factor=2.0,
                                                                 mode="nearest"))
        x = _conv2d(w, "dec.conv_out", F.silu(_gn(w, "dec.conv_norm_out", x)))
        return x.permute(0, 2, 3, 1)


# --------------------------------------------------------------------------- #
# T5-XXL's encoder and CLIP-L's text tower
# --------------------------------------------------------------------------- #

def relative_position_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int):
    """transformers ``T5Attention._relative_position_bucket``, bidirectional."""
    num_buckets //= 2
    out = (rel > 0).long() * num_buckets
    n = rel.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float() / max_exact) / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = torch.minimum(large, torch.full_like(large, num_buckets - 1))
    return out + torch.where(n < max_exact, n, large)


def t5_position_bias(w0: W, c: dict, L: int, device) -> torch.Tensor:
    """[1, H, L, L] from block 0's table (key position less query position)."""
    pos = torch.arange(L, device=device)
    buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                       c["relative_attention_num_buckets"],
                                       c["relative_attention_max_distance"])
    return w0["block0.attn.relative_attention_bias"][buckets].permute(2, 0, 1)[None]


@torch.no_grad()
def t5_embed(w: W, ids: torch.Tensor) -> torch.Tensor:
    return w["shared.weight"][ids]


@torch.no_grad()
def t5_block(w: W, c: dict, i: int, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """One ``T5Block``: RMS-normed self-attention with no 1/sqrt(d) scale and
    the shared position bias, then the gated tanh-GELU feed-forward."""
    with float32_math():
        p, eps = f"block{i}.", c["layer_norm_eps"]
        x = x.float()
        h = _rms(x, w[p + "ln1.weight"], eps)
        q, k, v = (_heads(_lin(w, p + "attn." + n, h), c["num_heads"]) for n in "qkv")
        x = x + _lin(w, p + "attn.o", _unheads(_softmax_attention(q, k, v, 1.0, bias)))
        h = _rms(x, w[p + "ln2.weight"], eps)
        g = F.gelu(_lin(w, p + "wi_0", h), approximate="tanh") * _lin(w, p + "wi_1", h)
        return x + _lin(w, p + "wo", g)


@torch.no_grad()
def t5_final(w: W, c: dict, x: torch.Tensor) -> torch.Tensor:
    return _rms(x.float(), w["final_norm.weight"], c["layer_norm_eps"])


@torch.no_grad()
def clip_pooled(w: W, c: dict, ids: torch.Tensor) -> torch.Tensor:
    """CLIPTextModel's pooled output [B, D]: pre-LN blocks with a causal mask
    and quick-GELU, the final LayerNorm, at the end-of-text token, the
    highest id (transformers' rule for this checkpoint's eos_token_id 2)."""
    with float32_math():
        B, L = ids.shape
        D, H, eps = c["hidden_size"], c["num_heads"], c["layer_norm_eps"]
        x = w["token_embedding.weight"][ids] + w["position_embedding"][None, :L]
        mask = torch.full((L, L), float("-inf"), device=ids.device).triu(1)[None]
        for i in range(c["num_layers"]):
            p = f"layer{i}."
            h = F.layer_norm(x, (D,), w[p + "layer_norm1.weight"], w[p + "layer_norm1.bias"], eps)
            q, k, v = (_heads(_lin(w, p + n, h), H) for n in ("q_proj", "k_proj", "v_proj"))
            attn = _softmax_attention(q, k, v, (D // H) ** -0.5, mask[None])
            x = x + _lin(w, p + "out_proj", _unheads(attn))
            h = F.layer_norm(x, (D,), w[p + "layer_norm2.weight"], w[p + "layer_norm2.bias"], eps)
            h = _lin(w, p + "fc1", h)
            x = x + _lin(w, p + "fc2", h * torch.sigmoid(1.702 * h))
        x = F.layer_norm(x, (D,), w["final_layer_norm.weight"], w["final_layer_norm.bias"], eps)
        return x[torch.arange(B, device=ids.device), ids.argmax(dim=-1)]


def tokenize(prompt: str, assets_dir: str, clip_len: int, t5_len: int):
    """(CLIP ids [1, clip_len], T5 ids [1, t5_len]) by the checkpoint
    tokenizers on the vocabulary files under ``assets_dir``, as the
    pipeline pads them (CLIP with its end-of-text id, T5 with 0)."""
    d = os.path.join(assets_dir, "tokenizers")
    clip = ClipBpeTokenizer.from_files(os.path.join(d, "flux_clip", "vocab.json"),
                                       os.path.join(d, "flux_clip", "merges.txt"))
    t5 = UnigramTokenizer.from_tokenizer_json(os.path.join(d, "flux_t5", "tokenizer.json"))
    return (clip.encode(prompt, max_len=clip_len),
            t5.encode(prompt, max_len=t5_len, pad_to_max=True))


# --------------------------------------------------------------------------- #
# the Kontext pipeline's pieces
# --------------------------------------------------------------------------- #

def sigmas(num_steps: int, n_img: int) -> np.ndarray:
    """[num_steps + 1] float64: linspace(1, 1/num_steps), shifted by
    exp(mu) / (exp(mu) + 1/s - 1) with mu from the image's sequence length
    (diffusers ``calculate_shift``: 0.5 at 256 tokens, 1.15 at 4,096), then 0."""
    s = np.linspace(1.0, 1.0 / num_steps, num_steps)
    mu = 0.5 + (n_img - 256) * (1.15 - 0.5) / (4096 - 256)
    shifted = math.exp(mu) / (math.exp(mu) + (1.0 / s - 1.0))
    return np.concatenate([shifted, [0.0]])


def pack(z: torch.Tensor) -> torch.Tensor:
    """[B, h, w, C] latents -> [B, (h/2)(w/2), 4C] tokens: diffusers
    ``_pack_latents`` (feature c*4 + 2*dy + dx) on channels-last latents."""
    B, h, w, C = z.shape
    z = z.permute(0, 3, 1, 2).reshape(B, C, h // 2, 2, w // 2, 2)
    return z.permute(0, 2, 4, 1, 3, 5).reshape(B, (h // 2) * (w // 2), C * 4)


def unpack(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    B, _, D = tokens.shape
    z = tokens.reshape(B, h // 2, w // 2, D // 4, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return z.reshape(B, D // 4, h, w).permute(0, 2, 3, 1)


def position_ids(h: int, w: int, n_txt: int, device):
    """(the noise's and the context image's token ids, first axis 0 and 1, then
    row and column; the text's ids, all 0) of h x w latents."""
    rows, cols = torch.meshgrid(torch.arange(h // 2), torch.arange(w // 2), indexing="ij")
    grid = torch.stack([torch.zeros_like(rows), rows, cols], -1).reshape(-1, 3).float()
    ctx = grid.clone()
    ctx[:, 0] = 1.0
    return (torch.cat([grid, ctx]).to(device),
            torch.zeros((n_txt, 3), dtype=torch.float32, device=device))


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative Frobenius gap."""
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm().clamp(min=1e-30)).item()

