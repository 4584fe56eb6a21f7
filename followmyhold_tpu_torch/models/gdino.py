"""GroundingDINO (the text-prompted detector) in PyTorch.

Counterpart of followmyhold_tpu/models/gdino.py, the port of HF's
GroundingDinoForObjectDetection, so the grounding-dino-base checkpoint maps
onto it: the detector behind the original pipeline's LangSAM front end.

Swin-B features (strides 8, 16, 32 and a fourth level by a strided conv)
and BERT text features, projected to d_model = 256; a 6-layer encoder (the
bi-directional vision-text attention, text self-attention and multi-scale
deformable attention over the image); two-stage query selection (the top 900
of 13,294 proposals at 800^2); a 6-layer decoder with iterative box
refinement; class logits as dot products against the encoder's text
features. The batch is full-valid single images, as the pipeline runs it, so
the valid ratios are 1.

Deformable attention samples bilinearly with zeros outside the map and
align_corners=False, one gather per corner and level. The vision-text
attention subtracts the logit tensor's global maximum (over batch, heads and
both axes) and clamps to +-50,000, as the reference does. The query
selection sorts the proposals' scores stably in descending order
(``jax.lax.top_k``'s order: the lower index first on ties). The text
self-attention bias adds float32's lowest value and stays float32. Every
attention is written out in plain PyTorch; the model runs float32 apart from
its Swin and BERT towers (bf16 at ``GDINO_BASE``). Convolutions run NCHW on
cuDNN; the token sequences are the maps flattened row-major, as the
reference's NHWC reshapes flatten them.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from followmyhold_tpu_torch.models.bert import BERT_BASE, BERT_TINY_TEST, BertConfig, BertModel
from followmyhold_tpu_torch.models.hunyuan import LayerNormF32
from followmyhold_tpu_torch.models.swin import SWIN_B, SWIN_TINY_TEST, SwinBackbone, SwinConfig
from followmyhold_tpu_torch.ops.norms import group_norm_f32


@dataclasses.dataclass(frozen=True)
class GroundingDinoConfig:
    swin: SwinConfig = SWIN_B
    bert: BertConfig = BERT_BASE
    d_model: int = 256
    num_queries: int = 900
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_heads: int = 8
    decoder_heads: int = 8
    encoder_ffn_dim: int = 2048
    decoder_ffn_dim: int = 2048
    num_feature_levels: int = 4
    encoder_n_points: int = 4
    decoder_n_points: int = 4
    max_text_len: int = 256
    layer_norm_eps: float = 1e-5
    position_embedding_temperature: float = 20.0
    image_size: int = 800            # the square resize of the image
    dtype: torch.dtype = torch.float32


GDINO_BASE = GroundingDinoConfig()
GDINO_TINY = GroundingDinoConfig(
    swin=SWIN_TINY_TEST, bert=BERT_TINY_TEST, d_model=32, num_queries=12,
    encoder_layers=1, decoder_layers=1, encoder_heads=2, decoder_heads=2,
    encoder_ffn_dim=64, decoder_ffn_dim=64, num_feature_levels=3,
    encoder_n_points=2, decoder_n_points=2, max_text_len=16, image_size=64)


# --------------------------------------------------------------------------- #
# position encodings
# --------------------------------------------------------------------------- #

def _sin_cos(p: torch.Tensor) -> torch.Tensor:
    """[..., n] angles -> [..., n]: sin of the even entries and cos of the odd
    ones, interleaved."""
    return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                       dim=-1).reshape(*p.shape[:-1], -1)


def get_sine_pos_embed(pos: torch.Tensor, num_pos_feats: int, temperature: float = 10000.0,
                       exchange_xy: bool = True) -> torch.Tensor:
    """[..., n] -> [..., n * num_pos_feats] (modeling_grounding_dino.py:1043)."""
    scale = 2 * math.pi
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    embs = [_sin_cos(pos[..., i:i + 1] * scale / dim_t) for i in range(pos.shape[-1])]
    if exchange_xy:
        embs[0], embs[1] = embs[1], embs[0]
    return torch.cat(embs, dim=-1)


def vision_sine_pos(h: int, w: int, d_model: int, temperature: float,
                    device=None) -> torch.Tensor:
    """The full-valid sine position map [h, w, d_model]
    (GroundingDinoSinePositionEmbedding with pixel_mask = 1)."""
    half = d_model // 2
    scale = 2 * math.pi
    eps = 1e-6
    y = (torch.arange(h, dtype=torch.float32, device=device) + 1.0) / (h + eps) * scale
    x = (torch.arange(w, dtype=torch.float32, device=device) + 1.0) / (w + eps) * scale
    dim_t = torch.arange(half, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / half)
    pos_y = _sin_cos(y[:, None] / dim_t)[:, None].expand(h, w, half)
    pos_x = _sin_cos(x[:, None] / dim_t)[None].expand(h, w, half)
    return torch.cat([pos_y, pos_x], dim=-1)


# --------------------------------------------------------------------------- #
# multi-scale deformable attention
# --------------------------------------------------------------------------- #

def _grid_sample_zeros(value: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples with zeros outside, align_corners=False: value
    [N, h, w, d]; gx, gy [N, S] in [-1, 1] -> [N, S, d]."""
    N, h, w, d = value.shape
    x = ((gx + 1.0) * w - 1.0) / 2.0
    y = ((gy + 1.0) * h - 1.0) / 2.0
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    flat = value.reshape(N, h * w, d)

    def gather(yi, xi):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()     # [N, S]
        g = torch.gather(flat, 1, idx[..., None].expand(-1, -1, d))
        return g * inb[..., None]

    wx1 = x - x0
    wy1 = y - y0
    return (gather(y0, x0) * ((1 - wx1) * (1 - wy1))[..., None]
            + gather(y0, x0 + 1) * (wx1 * (1 - wy1))[..., None]
            + gather(y0 + 1, x0) * ((1 - wx1) * wy1)[..., None]
            + gather(y0 + 1, x0 + 1) * (wx1 * wy1)[..., None])


def ms_deform_sample(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                     sampling_locations: torch.Tensor,
                     attention_weights: torch.Tensor) -> torch.Tensor:
    """value [B, S, H, hd]; sampling_locations [B, Q, H, L, P, 2] in [0, 1];
    attention_weights [B, Q, H, L, P] -> [B, Q, H * hd]."""
    B, S, H, hd = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    grids = 2 * sampling_locations - 1
    start = 0
    sampled = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].permute(0, 2, 1, 3).reshape(B * H, h, w, hd)
        g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(B * H, Q * P, 2)
        s = _grid_sample_zeros(v, g[..., 0], g[..., 1])                  # [BH, QP, hd]
        sampled.append(s.reshape(B, H, Q, P, hd))
        start += h * w
    stacked = torch.stack(sampled, dim=3)                                # [B, H, Q, L, P, hd]
    wts = attention_weights.permute(0, 2, 1, 3, 4)                       # [B, H, Q, L, P]
    out = torch.sum(stacked * wts[..., None], dim=(3, 4))                # [B, H, Q, hd]
    return out.permute(0, 2, 1, 3).reshape(B, Q, H * hd)


class DeformableAttention(nn.Module):
    """GroundingDinoMultiscaleDeformableAttention (deformable-DETR style)."""

    def __init__(self, cfg: GroundingDinoConfig, heads: int, n_points: int, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.heads, self.n_points = heads, n_points
        L = c.num_feature_levels
        kw = dict(dtype=c.dtype, device=device)
        self.value_proj = nn.Linear(c.d_model, c.d_model, **kw)
        self.sampling_offsets = nn.Linear(c.d_model, heads * L * n_points * 2, **kw)
        self.attention_weights = nn.Linear(c.d_model, heads * L * n_points, **kw)
        self.output_proj = nn.Linear(c.d_model, c.d_model, **kw)

    def forward(self, hidden_states, encoder_hidden_states, position_embeddings,
                reference_points, spatial_shapes: Sequence[Tuple[int, int]]):
        c = self.cfg
        L, heads, P = c.num_feature_levels, self.heads, self.n_points
        if position_embeddings is not None:
            hidden_states = hidden_states + position_embeddings
        B, Q, _ = hidden_states.shape
        S = encoder_hidden_states.shape[1]
        hd = c.d_model // heads
        value = self.value_proj(encoder_hidden_states).reshape(B, S, heads, hd)
        offsets = self.sampling_offsets(hidden_states).reshape(B, Q, heads, L, P, 2)
        attn = self.attention_weights(hidden_states).reshape(B, Q, heads, L * P)
        attn = torch.softmax(attn.float(), dim=-1).reshape(B, Q, heads, L, P).to(c.dtype)
        if reference_points.shape[-1] == 2:
            normalizer = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                                      dtype=torch.float32, device=offsets.device)   # [L, 2]
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / normalizer[None, None, None, :, None, :])
        else:  # 4: (cx, cy, w, h)
            loc = (reference_points[:, :, None, :, None, :2]
                   + offsets / P * reference_points[:, :, None, :, None, 2:] * 0.5)
        return self.output_proj(ms_deform_sample(value, spatial_shapes, loc, attn))


# --------------------------------------------------------------------------- #
# attention and fusion blocks
# --------------------------------------------------------------------------- #

def _ln(cfg: GroundingDinoConfig, dim: int, device) -> LayerNormF32:
    return LayerNormF32(dim, True, cfg.dtype, device, eps=cfg.layer_norm_eps)


class MultiheadAttention(nn.Module):
    """GroundingDinoMultiheadAttention (separate q/k/v, an additive float mask)."""

    def __init__(self, cfg: GroundingDinoConfig, heads: int, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.heads = heads
        kw = dict(dtype=c.dtype, device=device)
        self.query = nn.Linear(c.d_model, c.d_model, **kw)
        self.key = nn.Linear(c.d_model, c.d_model, **kw)
        self.value = nn.Linear(c.d_model, c.d_model, **kw)
        self.out_proj = nn.Linear(c.d_model, c.d_model, **kw)

    def forward(self, queries, keys, values, attn_bias=None):
        c = self.cfg
        B, Q, _ = queries.shape
        hd = c.d_model // self.heads

        def split(t):
            return t.reshape(B, -1, self.heads, hd).permute(0, 2, 1, 3)

        q, k, v = split(self.query(queries)), split(self.key(keys)), split(self.value(values))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        if attn_bias is not None:
            logits = logits + attn_bias
        probs = torch.softmax(logits, dim=-1).to(c.dtype)
        out = torch.matmul(probs.float(), v.float()).to(c.dtype)
        return self.out_proj(out.permute(0, 2, 1, 3).reshape(B, Q, c.d_model))


class BiMultiHeadAttention(nn.Module):
    """GroundingDinoBiMultiHeadAttention: image-to-text and text-to-image
    attention on one shared [vision, text] logit matrix."""

    def __init__(self, cfg: GroundingDinoConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        e = c.encoder_ffn_dim // 2
        kw = dict(dtype=c.dtype, device=device)
        self.vision_proj = nn.Linear(c.d_model, e, **kw)
        self.text_proj = nn.Linear(c.d_model, e, **kw)
        self.values_vision_proj = nn.Linear(c.d_model, e, **kw)
        self.values_text_proj = nn.Linear(c.d_model, e, **kw)
        self.out_vision_proj = nn.Linear(e, c.d_model, **kw)
        self.out_text_proj = nn.Linear(e, c.d_model, **kw)

    def forward(self, vision, text, text_mask=None):
        c = self.cfg
        embed_dim = c.encoder_ffn_dim // 2
        heads = c.encoder_heads // 2
        hd = embed_dim // heads
        B, NV, _ = vision.shape
        NT = text.shape[1]

        def split(t):
            return t.reshape(B, -1, heads, hd).permute(0, 2, 1, 3)

        vq = split(self.vision_proj(vision) * (hd ** -0.5))
        tk = split(self.text_proj(text))
        vv = split(self.values_vision_proj(vision))
        tv = split(self.values_text_proj(text))

        logits = torch.matmul(vq.float(), tk.float().transpose(-1, -2))     # [B, h, NV, NT]
        logits = logits - logits.max()
        logits = torch.clamp(logits, -50000.0, 50000.0)
        t_logits = logits.transpose(2, 3)                                   # [B, h, NT, NV]
        t_logits = t_logits - t_logits.max(dim=-1, keepdim=True).values
        t_logits = torch.clamp(t_logits, -50000.0, 50000.0)
        text_attn = torch.softmax(t_logits, dim=-1)
        if text_mask is not None:  # True = padding
            logits = logits.masked_fill(text_mask[:, None, None, :], -float("inf"))
        vision_attn = torch.softmax(logits, dim=-1)

        v_out = torch.matmul(vision_attn.to(c.dtype).float(), tv.float()).to(c.dtype)
        t_out = torch.matmul(text_attn.to(c.dtype).float(), vv.float()).to(c.dtype)
        v_out = v_out.permute(0, 2, 1, 3).reshape(B, NV, embed_dim)
        t_out = t_out.permute(0, 2, 1, 3).reshape(B, NT, embed_dim)
        return self.out_vision_proj(v_out), self.out_text_proj(t_out)


class FusionLayer(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.layer_norm_vision = _ln(c, c.d_model, device)
        self.layer_norm_text = _ln(c, c.d_model, device)
        self.attn = BiMultiHeadAttention(c, device)
        self.vision_param = nn.Parameter(torch.full((c.d_model,), 1e-4, device=device))
        self.text_param = nn.Parameter(torch.full((c.d_model,), 1e-4, device=device))

    def forward(self, vision, text, text_mask=None):
        vn = self.layer_norm_vision(vision)
        tn = self.layer_norm_text(text)
        dv, dt = self.attn(vn, tn, text_mask)
        return vn + self.vision_param * dv, tn + self.text_param * dt


class TextEnhancerLayer(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        kw = dict(dtype=c.dtype, device=device)
        self.self_attn = MultiheadAttention(c, c.encoder_heads // 2, device)
        self.layer_norm_before = _ln(c, c.d_model, device)
        self.fc1 = nn.Linear(c.d_model, c.encoder_ffn_dim // 2, **kw)
        self.fc2 = nn.Linear(c.encoder_ffn_dim // 2, c.d_model, **kw)
        self.layer_norm_after = _ln(c, c.d_model, device)

    def forward(self, text, self_attn_bias, pos):
        q = text + pos
        x = self.layer_norm_before(text + self.self_attn(q, q, text, self_attn_bias))
        return self.layer_norm_after(x + self.fc2(F.relu(self.fc1(x))))


class DeformableLayer(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        kw = dict(dtype=c.dtype, device=device)
        self.self_attn = DeformableAttention(c, c.encoder_heads, c.encoder_n_points, device)
        self.self_attn_layer_norm = _ln(c, c.d_model, device)
        self.fc1 = nn.Linear(c.d_model, c.encoder_ffn_dim, **kw)
        self.fc2 = nn.Linear(c.encoder_ffn_dim, c.d_model, **kw)
        self.final_layer_norm = _ln(c, c.d_model, device)

    def forward(self, vision, pos, reference_points, spatial_shapes):
        attn = self.self_attn(vision, vision, pos, reference_points, spatial_shapes)
        x = self.self_attn_layer_norm(vision + attn)
        return self.final_layer_norm(x + self.fc2(F.relu(self.fc1(x))))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig, device=None):
        super().__init__()
        self.fusion_layer = FusionLayer(cfg, device)
        self.text_enhancer_layer = TextEnhancerLayer(cfg, device)
        self.deformable_layer = DeformableLayer(cfg, device)

    def forward(self, vision, vision_pos, text, text_pos, text_self_bias, text_pad_mask,
                reference_points, spatial_shapes):
        vision, text = self.fusion_layer(vision, text, text_pad_mask)
        text = self.text_enhancer_layer(text, text_self_bias, text_pos)
        vision = self.deformable_layer(vision, vision_pos, reference_points, spatial_shapes)
        return vision, text


class DecoderLayer(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        kw = dict(dtype=c.dtype, device=device)
        self.self_attn = MultiheadAttention(c, c.decoder_heads, device)
        self.self_attn_layer_norm = _ln(c, c.d_model, device)
        self.encoder_attn_text = MultiheadAttention(c, c.decoder_heads, device)
        self.encoder_attn_text_layer_norm = _ln(c, c.d_model, device)
        self.encoder_attn = DeformableAttention(c, c.decoder_heads, c.decoder_n_points, device)
        self.encoder_attn_layer_norm = _ln(c, c.d_model, device)
        self.fc1 = nn.Linear(c.d_model, c.decoder_ffn_dim, **kw)
        self.fc2 = nn.Linear(c.decoder_ffn_dim, c.d_model, **kw)
        self.final_layer_norm = _ln(c, c.d_model, device)

    def forward(self, hidden, query_pos, reference_points, spatial_shapes, vision, text,
                text_bias):
        q = hidden + query_pos
        hidden = self.self_attn_layer_norm(hidden + self.self_attn(q, q, hidden))
        q = hidden + query_pos
        hidden = self.encoder_attn_text_layer_norm(
            hidden + self.encoder_attn_text(q, text, text, text_bias))
        attn = self.encoder_attn(hidden, vision, query_pos, reference_points, spatial_shapes)
        hidden = self.encoder_attn_layer_norm(hidden + attn)
        return self.final_layer_norm(hidden + self.fc2(F.relu(self.fc1(hidden))))


class MLPPredictionHead(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, num_layers: int, dtype,
                 device=None):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1)
        for i in range(num_layers - 1):
            self.add_module(f"layer{i}", nn.Linear(dims[i], hidden_dim, dtype=dtype,
                                                   device=device))
        self.add_module(f"layer{num_layers - 1}", nn.Linear(
            dims[-1], output_dim, dtype=torch.float32, device=device))

    def forward(self, x):
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"layer{i}")(x))
        last = getattr(self, f"layer{self.num_layers - 1}")
        return last(x.float())


def _logit(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


def contrastive_logits(vision_hidden, text_hidden, text_token_mask,
                       max_text_len: int) -> torch.Tensor:
    """GroundingDinoContrastiveEmbedding: [B, Q, D] x [B, T, D] ->
    [B, Q, max_text_len], -inf at the text's padding and beyond it."""
    out = torch.matmul(vision_hidden.float(), text_hidden.float().transpose(-1, -2))
    out = out.masked_fill(~text_token_mask[:, None, :], -float("inf"))
    pad = max_text_len - out.shape[-1]
    if pad > 0:
        out = F.pad(out, (0, pad), value=-float("inf"))
    return out[..., :max_text_len]


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #

class GroundingDino(nn.Module):
    """Two-stage GroundingDINO -> dict(logits, pred_boxes, ...)."""

    def __init__(self, cfg: GroundingDinoConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        f32 = dict(dtype=torch.float32, device=device)
        self.text_backbone = BertModel(c.bert, device)
        self.text_projection = nn.Linear(c.bert.hidden_size, c.d_model, dtype=c.dtype,
                                         device=device)
        self.backbone = SwinBackbone(c.swin, device)
        chans = c.swin.out_channels
        for lvl in range(c.num_feature_levels):
            if lvl < len(chans):
                conv = nn.Conv2d(chans[lvl], c.d_model, 1, dtype=c.dtype, device=device)
            else:
                cin = chans[-1] if lvl == len(chans) else c.d_model
                conv = nn.Conv2d(cin, c.d_model, 3, stride=2, padding=1, dtype=c.dtype,
                                 device=device)
            self.add_module(f"input_proj_{lvl}", conv)
            self.add_module(f"input_proj_norm_{lvl}",
                            nn.GroupNorm(min(32, c.d_model), c.d_model, **f32))
        self.level_embed = nn.Parameter(torch.zeros(c.num_feature_levels, c.d_model, **f32))
        for i in range(c.encoder_layers):
            self.add_module(f"encoder_layer{i}", EncoderLayer(c, device))
        self.enc_output = nn.Linear(c.d_model, c.d_model, dtype=c.dtype, device=device)
        self.enc_output_norm = _ln(c, c.d_model, device)
        self.encoder_output_bbox_embed = MLPPredictionHead(c.d_model, c.d_model, 4, 3, c.dtype,
                                                           device)
        self.query_position_embeddings = nn.Parameter(torch.zeros(c.num_queries, c.d_model,
                                                                  **f32))
        self.decoder_bbox_embed = MLPPredictionHead(c.d_model, c.d_model, 4, 3, c.dtype, device)
        self.reference_points_head = MLPPredictionHead(2 * c.d_model, c.d_model, c.d_model, 2,
                                                       c.dtype, device)
        self.decoder_layer_norm = LayerNormF32(c.d_model, True, torch.float32, device,
                                               eps=c.layer_norm_eps)
        for i in range(c.decoder_layers):
            self.add_module(f"decoder_layer{i}", DecoderLayer(c, device))

    def _feature_maps(self, pixel_values: torch.Tensor):
        """Swin's stages and the extra levels, projected and group-normed:
        NCHW float32 maps of d_model channels."""
        c = self.cfg
        feats = [f.permute(0, 3, 1, 2) for f in self.backbone(pixel_values)]
        maps = []
        for lvl in range(c.num_feature_levels):
            src = feats[lvl] if lvl < len(feats) else (
                feats[-1] if lvl == len(feats) else maps[-1])
            x = getattr(self, f"input_proj_{lvl}")(src.to(c.dtype))
            maps.append(group_norm_f32(x, getattr(self, f"input_proj_norm_{lvl}")).to(c.dtype))
        return maps

    def forward(self, pixel_values, input_ids, token_type_ids, text_self_attention_masks,
                position_ids, text_token_mask) -> dict:
        """pixel_values [B, H, W, 3] ImageNet-normalised; input_ids,
        token_type_ids, position_ids [B, T]; text_self_attention_masks [B, T, T]
        bool (True = attend); text_token_mask [B, T] bool (True = a real token)."""
        c = self.cfg
        dev = self.level_embed.device
        input_ids, token_type_ids, position_ids = (
            t.to(dev) for t in (input_ids, token_type_ids, position_ids))
        pair_mask = text_self_attention_masks.to(dev)
        text_token_mask = text_token_mask.to(dev)
        B = pixel_values.shape[0]
        d = c.d_model

        # ---- the text tower ----
        text_feat = self.text_backbone(input_ids, pair_mask, token_type_ids, position_ids)
        text_feat = self.text_projection(text_feat.to(c.dtype))
        text_pad_mask = ~text_token_mask                                    # True = padding
        text_self_bias = (1.0 - pair_mask.float())[:, None] * torch.finfo(torch.float32).min
        text_pos = get_sine_pos_embed(position_ids[..., None].float(), d,
                                      exchange_xy=False).to(c.dtype)

        # ---- the vision tower ----
        maps = self._feature_maps(pixel_values.to(dev))
        spatial_shapes = [(m.shape[2], m.shape[3]) for m in maps]
        source_flat = torch.cat([m.flatten(2).transpose(1, 2) for m in maps], dim=1)
        pos_flat = torch.cat([
            (vision_sine_pos(h, w, d, c.position_embedding_temperature, dev).reshape(1, -1, d)
             + self.level_embed[lvl][None, None])
            for lvl, (h, w) in enumerate(spatial_shapes)], dim=1)
        pos_flat = pos_flat.expand(source_flat.shape).to(c.dtype)

        # the encoder's reference points (valid ratios 1)
        refs = []
        for (h, w) in spatial_shapes:
            ry = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
            rx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
            gy, gx = torch.meshgrid(ry, rx, indexing="ij")
            refs.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        enc_ref = torch.cat(refs, dim=0)
        enc_ref = enc_ref[None, :, None, :].expand(B, enc_ref.shape[0], c.num_feature_levels, 2)

        # ---- the encoder ----
        vision, text = source_flat, text_feat
        for i in range(c.encoder_layers):
            vision, text = getattr(self, f"encoder_layer{i}")(
                vision, pos_flat, text, text_pos, text_self_bias, text_pad_mask, enc_ref,
                spatial_shapes)

        # ---- two-stage query selection ----
        props = []
        for lvl, (h, w) in enumerate(spatial_shapes):
            gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                    torch.arange(w, dtype=torch.float32, device=dev),
                                    indexing="ij")
            grid = torch.stack([(gx + 0.5) / w, (gy + 0.5) / h], -1)
            wh = torch.full_like(grid, 0.05 * 2.0 ** lvl)
            props.append(torch.cat([grid, wh], -1).reshape(-1, 4))
        proposals = torch.cat(props, dim=0)[None]                          # [1, S, 4]
        valid = torch.all((proposals > 0.01) & (proposals < 0.99), -1, keepdim=True)
        proposals = torch.log(proposals / (1 - proposals))
        proposals = torch.where(valid, proposals, torch.full_like(proposals, float("inf")))
        proposals = proposals.expand(B, *proposals.shape[1:])

        obj_query = torch.where(valid, vision, torch.zeros((), dtype=vision.dtype, device=dev))
        obj_query = self.enc_output_norm(self.enc_output(obj_query))
        enc_logits = contrastive_logits(obj_query, text, text_token_mask, c.max_text_len)
        enc_coord_logits = self.encoder_output_bbox_embed(obj_query) + proposals

        topk_scores = torch.where(torch.isinf(enc_logits),
                                  torch.full_like(enc_logits, -float("inf")),
                                  enc_logits).max(-1).values                 # [B, S]
        topk_idx = torch.sort(topk_scores, dim=-1, descending=True,
                              stable=True).indices[:, :c.num_queries]
        topk_coords = torch.gather(enc_coord_logits, 1, topk_idx[..., None].expand(-1, -1, 4))
        reference_points = torch.sigmoid(topk_coords)
        init_reference = reference_points
        target = self.query_position_embeddings[None].expand(B, -1, -1).to(c.dtype)

        # ---- the decoder, with iterative box refinement ----
        text_cross_bias = torch.where(text_pad_mask[:, None, None, :],
                                      torch.finfo(torch.float32).min, 0.0)
        hidden = target
        intermediate, intermediate_refs = [], []
        for i in range(c.decoder_layers):
            ref_input = reference_points[:, :, None, :].expand(B, c.num_queries,
                                                               c.num_feature_levels, 4)
            query_sine = get_sine_pos_embed(ref_input[:, :, 0, :], d // 2)
            query_pos = self.reference_points_head(query_sine).to(c.dtype)
            hidden = getattr(self, f"decoder_layer{i}")(
                hidden, query_pos, ref_input, spatial_shapes, vision, text, text_cross_bias)
            delta = self.decoder_bbox_embed(hidden)
            reference_points = torch.sigmoid(delta + _logit(reference_points))
            intermediate.append(self.decoder_layer_norm(hidden))
            intermediate_refs.append(reference_points)

        # ---- the per-layer heads ----
        outputs_classes, outputs_coords = [], []
        for lvl in range(c.decoder_layers):
            ref = init_reference if lvl == 0 else intermediate_refs[lvl - 1]
            cls = contrastive_logits(intermediate[lvl], text, text_token_mask, c.max_text_len)
            delta = self.decoder_bbox_embed(intermediate[lvl].to(c.dtype))
            outputs_classes.append(cls)
            outputs_coords.append(torch.sigmoid(delta + _logit(ref)))
        return dict(
            logits=outputs_classes[-1],
            pred_boxes=outputs_coords[-1],
            all_logits=torch.stack(outputs_classes, 1),
            all_boxes=torch.stack(outputs_coords, 1),
            enc_logits=enc_logits,
            enc_coord_logits=enc_coord_logits,
            encoder_text=text,
            encoder_vision=vision,
        )


# --------------------------------------------------------------------------- #
# host-side helpers (the tokenised prompt)
# --------------------------------------------------------------------------- #

SPECIAL_TOKENS = (101, 102, 1012, 1029)   # [CLS], [SEP], '.', '?'


def generate_special_token_masks(input_ids: np.ndarray):
    """The per-phrase text self-attention mask [B, T, T] and position ids
    [B, T] (modeling_grounding_dino.py:1863-1906), on the host."""
    bsz, n = input_ids.shape
    special = np.isin(input_ids, np.asarray(SPECIAL_TOKENS))
    attn = np.tile(np.eye(n, dtype=bool)[None], (bsz, 1, 1))
    position_ids = np.zeros((bsz, n), np.int64)
    for row in range(bsz):
        prev = 0
        for col in np.nonzero(special[row])[0]:
            if col == 0 or col == n - 1:
                attn[row, col, col] = True
                position_ids[row, col] = 0
            else:
                attn[row, prev + 1:col + 1, prev + 1:col + 1] = True
                position_ids[row, prev + 1:col + 1] = np.arange(col - prev)
            prev = col
    return attn, position_ids


IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def preprocess_inputs(image_rgb: np.ndarray, input_ids: np.ndarray, image_size: int) -> dict:
    """The square resize and normalisation of the image (PIL, on the host)
    and the text-side masks: the keyword arguments of ``GroundingDino``."""
    from PIL import Image

    img = Image.fromarray(image_rgb).resize((image_size, image_size))
    pix = (np.asarray(img, np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    attn, pos_ids = generate_special_token_masks(input_ids)
    ids = torch.from_numpy(np.asarray(input_ids, np.int64))
    return dict(
        pixel_values=torch.from_numpy(np.ascontiguousarray(pix[None], np.float32)),
        input_ids=ids,
        token_type_ids=torch.zeros_like(ids),
        text_self_attention_masks=torch.from_numpy(attn),
        position_ids=torch.from_numpy(pos_ids),
        text_token_mask=ids != 0,
    )


def preprocess_caption(prompt: str) -> str:
    """HF GroundingDinoProcessor's caption: lowercased, ending in '.'."""
    prompt = prompt.lower().strip()
    return prompt if prompt.endswith(".") else prompt + "."


def tokenize_prompt(prompt: str, vocab_size: int = 30522) -> np.ndarray:
    """The caption's ids with the checkpoint's WordPiece vocabulary
    (``<assets>/tokenizers/gdino/vocab.txt``). Without one: the stable-hash
    fallback, so seeded runs stay drivable, but a raise where a converted
    ``gdino`` file exists, since hashed ids would give confidently wrong
    detections (``FOHO_ALLOW_HASH_TOKENIZER=1`` overrides it)."""
    from followmyhold_tpu_torch.text.tokenizers import load_gdino_tokenizer, simple_tokenize
    from followmyhold_tpu_torch.utils.params import has_params

    caption = preprocess_caption(prompt)
    tok = load_gdino_tokenizer()
    if tok is not None:
        return tok.encode(caption, max_len=256)
    if has_params("gdino") and not os.environ.get("FOHO_ALLOW_HASH_TOKENIZER"):
        raise RuntimeError(
            "converted gdino params exist but no BERT vocab was installed "
            "(expected assets tokenizers/gdino/vocab.txt; set "
            "FOHO_ALLOW_HASH_TOKENIZER=1 to knowingly use hashed ids)")
    return simple_tokenize(caption, vocab_size=vocab_size)


def detect_text_prompt(model: GroundingDino, image_rgb: np.ndarray, prompt: str,
                       input_ids: Optional[np.ndarray] = None, box_threshold: float = 0.3):
    """LangSAM.predict-style detection on one image -> (xyxy boxes in image
    pixels, scores), the boxes above ``box_threshold``, best first."""
    c = model.cfg
    if input_ids is None:
        input_ids = tokenize_prompt(prompt, vocab_size=c.bert.vocab_size)
    with torch.no_grad():
        out = model(**preprocess_inputs(image_rgb, input_ids, c.image_size))
    logits = out["logits"][0].cpu().numpy()               # [Q, max_text_len]
    boxes = out["pred_boxes"][0].cpu().numpy()            # [Q, 4] cxcywh in [0, 1]
    with np.errstate(over="ignore"):
        scores = 1.0 / (1.0 + np.exp(-logits))
    scores = np.where(np.isfinite(logits), scores, 0.0).max(-1)
    H, W = image_rgb.shape[:2]
    cx, cy, w, h = boxes.T
    xyxy = np.stack([(cx - w / 2) * W, (cy - h / 2) * H,
                     (cx + w / 2) * W, (cy + h / 2) * H], -1)
    keep = scores > box_threshold
    order = np.argsort(-scores[keep])
    return xyxy[keep][order], scores[keep][order]
