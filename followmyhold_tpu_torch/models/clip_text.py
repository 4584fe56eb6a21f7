"""CLIP text encoder in PyTorch: FLUX's pooled-prompt tower.

Counterpart of followmyhold_tpu/models/clip_text.py (HF CLIPTextModel:
pre-LN blocks, quick-GELU MLP, causal mask, the pooled output the final
hidden state at the first EOS token), so openai/clip-vit-large-patch14, the
FLUX.1 text_encoder, maps onto it. Module and parameter names follow the Flax
modules (``token_embedding``, ``position_embedding``, ``layer{i}``,
``final_layer_norm``), so ``utils.params.flax_to_torch`` loads a Flax tree.

Numerics kept from the reference: the token and position embeddings are
summed in float32, then cast to the tower's type; LayerNorms in float32 with
epsilon 1e-5; attention logits (divided by sqrt(head size), the causal mask
added as float32's lowest value) and softmax in float32. The final
LayerNorm's output, and so the pooled vector, stays float32. The 77 tokens
take a plain product in both packages (the reference's einsum; the flash
path needs 256 or more).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from followmyhold_tpu_torch.models.hunyuan import LayerNormF32, _merge_heads, _split_heads


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    dtype: torch.dtype = torch.bfloat16


CLIP_L = ClipTextConfig()
CLIP_TINY_TEST = ClipTextConfig(vocab_size=1000, hidden_size=32, num_layers=2,
                                num_heads=2, intermediate_size=64,
                                max_position_embeddings=24, eos_token_id=999,
                                dtype=torch.float32)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ClipLayer(nn.Module):
    def __init__(self, cfg: ClipTextConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        D = c.hidden_size
        self.layer_norm1 = LayerNormF32(D, True, c.dtype, device, eps=c.layer_norm_eps)
        self.q_proj = nn.Linear(D, D, dtype=c.dtype, device=device)
        self.k_proj = nn.Linear(D, D, dtype=c.dtype, device=device)
        self.v_proj = nn.Linear(D, D, dtype=c.dtype, device=device)
        self.out_proj = nn.Linear(D, D, dtype=c.dtype, device=device)
        self.layer_norm2 = LayerNormF32(D, True, c.dtype, device, eps=c.layer_norm_eps)
        self.fc1 = nn.Linear(D, c.intermediate_size, dtype=c.dtype, device=device)
        self.fc2 = nn.Linear(c.intermediate_size, D, dtype=c.dtype, device=device)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        hd = c.hidden_size // c.num_heads
        h = self.layer_norm1(x)
        q, k, v = (_split_heads(proj(h), c.num_heads)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / hd ** 0.5 + causal
        attn = torch.matmul(torch.softmax(logits, dim=-1).to(c.dtype), v)
        x = x + self.out_proj(_merge_heads(attn))
        h = quick_gelu(self.fc1(self.layer_norm2(x)))
        return x + self.fc2(h)


class ClipTextModel(nn.Module):
    """input_ids [B, L] -> (last_hidden_state [B, L, D] float32, pooled [B, D] float32)."""

    def __init__(self, cfg: ClipTextConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size, dtype=torch.float32,
                                            device=device)
        self.position_embedding = nn.Parameter(torch.zeros(
            c.max_position_embeddings, c.hidden_size, dtype=torch.float32, device=device))
        for i in range(c.num_layers):
            self.add_module(f"layer{i}", ClipLayer(c, device))
        self.final_layer_norm = LayerNormF32(c.hidden_size, True, torch.float32, device,
                                             eps=c.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        B, L = input_ids.shape
        dev = self.position_embedding.device
        input_ids = input_ids.to(dev)
        x = (self.token_embedding(input_ids) + self.position_embedding[None, :L]).to(c.dtype)
        causal = torch.full((L, L), torch.finfo(torch.float32).min, device=dev).triu(1)
        for i in range(c.num_layers):
            x = getattr(self, f"layer{i}")(x, causal)
        x = self.final_layer_norm(x)
        # pooled: the hidden state at the first EOS token
        eos_pos = (input_ids == c.eos_token_id).int().argmax(dim=1)
        return x, x[torch.arange(B, device=dev), eos_pos]
