"""BERT text encoder in PyTorch: GroundingDINO's text tower.

Counterpart of followmyhold_tpu/models/bert.py (HF BertModel's encoder:
post-LN blocks, separate q/k/v, learned word, position and token-type
embeddings), so the grounding-dino-base checkpoint's text tower maps onto
it. GroundingDINO calls it with a per-pair self-attention mask [B, L, L]
(the blocks between special tokens) and explicit position ids; a mask adds
(1 - m) * float32's lowest value to the float32 logits, as there.

Numerics kept from the reference: the three embeddings summed and their
LayerNorm in float32, then the tower's type (bf16 at ``BERT_BASE``); each
LayerNorm in float32; the attention's logits and softmax in float32, both
products on the bf16 tensors' values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from followmyhold_tpu_torch.models.hunyuan import LayerNormF32


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16


BERT_BASE = BertConfig()
BERT_TINY_TEST = BertConfig(vocab_size=2048, hidden_size=32, num_hidden_layers=1,
                            num_attention_heads=2, intermediate_size=64,
                            max_position_embeddings=64, dtype=torch.float32)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        D = c.hidden_size
        self.query = nn.Linear(D, D, dtype=c.dtype, device=device)
        self.key = nn.Linear(D, D, dtype=c.dtype, device=device)
        self.value = nn.Linear(D, D, dtype=c.dtype, device=device)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor]) -> torch.Tensor:
        c = self.cfg
        B, L, _ = x.shape
        heads = c.num_attention_heads
        hd = c.hidden_size // heads

        def split(t):
            return t.reshape(B, L, heads, hd).permute(0, 2, 1, 3)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / float(hd) ** 0.5
        if attn_bias is not None:
            logits = logits + attn_bias
        probs = torch.softmax(logits, dim=-1).to(c.dtype)
        out = torch.matmul(probs.float(), v.float()).to(c.dtype)
        return out.permute(0, 2, 1, 3).reshape(B, L, c.hidden_size)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        D = c.hidden_size
        self.self = BertSelfAttention(c, device)
        self.attn_out = nn.Linear(D, D, dtype=c.dtype, device=device)
        self.attn_norm = LayerNormF32(D, True, c.dtype, device, eps=c.layer_norm_eps)
        self.intermediate = nn.Linear(D, c.intermediate_size, dtype=c.dtype, device=device)
        self.output = nn.Linear(c.intermediate_size, D, dtype=c.dtype, device=device)
        self.out_norm = LayerNormF32(D, True, c.dtype, device, eps=c.layer_norm_eps)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.attn_norm(x + self.attn_out(self.self(x, attn_bias)))
        h = self.output(F.gelu(self.intermediate(x)))
        return self.out_norm(x + h)


class BertModel(nn.Module):
    """-> last_hidden_state [B, L, hidden] in the tower's type."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        f32 = dict(dtype=torch.float32, device=device)
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size, **f32)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size, **f32)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size, **f32)
        self.embed_norm = LayerNormF32(c.hidden_size, True, c.dtype, device,
                                       eps=c.layer_norm_eps)
        for i in range(c.num_hidden_layers):
            self.add_module(f"layer{i}", BertLayer(c, device))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,   # [B, L] or [B, L, L]
                token_type_ids: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        dev = self.word_embeddings.weight.device
        input_ids = input_ids.to(dev)
        B, L = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = torch.arange(L, device=dev)[None].expand(B, L)
        x = (self.word_embeddings(input_ids) + self.position_embeddings(position_ids.to(dev))
             + self.token_type_embeddings(token_type_ids.to(dev)))
        x = self.embed_norm(x)

        attn_bias = None
        if attention_mask is not None:
            m = attention_mask.to(dev, torch.float32)
            m = m[:, None, None, :] if m.dim() == 2 else m[:, None, :, :]
            attn_bias = (1.0 - m) * torch.finfo(torch.float32).min
        for i in range(c.num_hidden_layers):
            x = getattr(self, f"layer{i}")(x, attn_bias)
        return x
