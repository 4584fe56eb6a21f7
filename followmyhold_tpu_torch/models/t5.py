"""T5 encoder in PyTorch: FLUX's sequence-prompt tower (text_encoder_2).

Counterpart of followmyhold_tpu/models/t5.py (HF T5EncoderModel: RMS norms,
bias-free projections, a bucketed relative position bias made by block 0 and
reused by every block, a gated tanh-GELU feed-forward), so
google/t5-v1_1-xxl maps onto it. Module and parameter names follow the Flax
modules (``shared``, ``block{i}/attn/{q,k,v,o}``,
``block0/attn/relative_attention_bias``, ``ln1``, ``ln2``, ``wi_0``,
``wi_1``, ``wo``, ``final_norm``), so ``utils.params.flax_to_torch`` loads a
Flax tree.

Numerics kept from the reference: no 1/sqrt(d) scale on the logits; q and k
are cast to float32 before their product, as the reference's
``preferred_element_type=float32`` keeps the unscaled logits unrounded, and the
bias and the softmax are float32; RMS norms in float32 with the input's
values, cast back. The attention is a plain product in both packages (the
reference computes it with ``einsum``, outside any Pallas kernel).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from followmyhold_tpu_torch.models.hunyuan import _merge_heads, _split_heads


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16


T5_XXL = T5Config()
T5_TINY_TEST = T5Config(vocab_size=500, d_model=32, d_kv=8, d_ff=64,
                        num_layers=2, num_heads=4, dtype=torch.float32)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * scale in float32, cast back to x's type."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight).to(x.dtype)


def relative_position_bucket(rel, num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """T5's bidirectional bucketing (modeling_t5._relative_position_bucket),
    on the host in numpy, as the reference computes it."""
    num_buckets //= 2
    ret = (rel > 0).astype(np.int64) * num_buckets
    n = np.abs(rel)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.has_bias = has_bias
        inner = c.num_heads * c.d_kv
        self.q = nn.Linear(c.d_model, inner, bias=False, dtype=c.dtype, device=device)
        self.k = nn.Linear(c.d_model, inner, bias=False, dtype=c.dtype, device=device)
        self.v = nn.Linear(c.d_model, inner, bias=False, dtype=c.dtype, device=device)
        self.o = nn.Linear(inner, c.d_model, bias=False, dtype=c.dtype, device=device)
        if has_bias:
            self.relative_attention_bias = nn.Parameter(torch.zeros(
                c.relative_attention_num_buckets, c.num_heads, dtype=torch.float32,
                device=device))

    def position_bias(self, L: int) -> torch.Tensor:
        """[1, H, L, L] float32 from the bucketed table."""
        c = self.cfg
        buckets = relative_position_bucket(
            np.arange(L)[None, :] - np.arange(L)[:, None],
            c.relative_attention_num_buckets, c.relative_attention_max_distance)
        table = self.relative_attention_bias
        return table[torch.from_numpy(buckets).to(table.device)].permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor, pos_bias: torch.Tensor):
        c = self.cfg
        q, k, v = (_split_heads(proj(x), c.num_heads) for proj in (self.q, self.k, self.v))
        if self.has_bias:
            pos_bias = self.position_bias(x.shape[1])
        # T5 does not scale by sqrt(d_kv)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + pos_bias
        probs = torch.softmax(logits, dim=-1).to(c.dtype)
        out = torch.matmul(probs, v)
        return self.o(_merge_heads(out)), pos_bias


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.ln1 = RMSNorm(c.d_model, c.layer_norm_eps, device)
        self.attn = T5Attention(c, has_bias, device)
        self.ln2 = RMSNorm(c.d_model, c.layer_norm_eps, device)
        self.wi_0 = nn.Linear(c.d_model, c.d_ff, bias=False, dtype=c.dtype, device=device)
        self.wi_1 = nn.Linear(c.d_model, c.d_ff, bias=False, dtype=c.dtype, device=device)
        self.wo = nn.Linear(c.d_ff, c.d_model, bias=False, dtype=c.dtype, device=device)

    def forward(self, x: torch.Tensor, pos_bias: torch.Tensor):
        attn, pos_bias = self.attn(self.ln1(x), pos_bias)
        x = x + attn
        h = self.ln2(x)
        g = F.gelu(self.wi_0(h), approximate="tanh")
        return x + self.wo(g * self.wi_1(h)), pos_bias


class T5Encoder(nn.Module):
    """input_ids [B, L] -> last_hidden_state [B, L, d_model] in the tower's type."""

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        c = self.cfg = cfg
        # the reference looks up float32 rows and casts them; rows stored in
        # the tower's type are the same values
        self.shared = nn.Embedding(c.vocab_size, c.d_model, dtype=c.dtype, device=device)
        for i in range(c.num_layers):
            self.add_module(f"block{i}", T5Block(c, i == 0, device))
        self.final_norm = RMSNorm(c.d_model, c.layer_norm_eps, device)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        dev = self.final_norm.weight.device
        x = self.shared(input_ids.to(dev)).to(c.dtype)
        pos_bias = torch.zeros((1, c.num_heads, 1, 1), dtype=torch.float32, device=dev)
        for i in range(c.num_layers):
            x, pos_bias = getattr(self, f"block{i}")(x, pos_bias)
        return self.final_norm(x)
