"""SAM 2 (Hiera) box-prompted image segmentation in PyTorch.

Counterpart of followmyhold_tpu/models/sam2.py, which replaces the original
pipeline's SAM2ImagePredictor (sam2.1_hiera_large, predict(box=...,
multimask_output=False)): the Hiera trunk and FPN neck, the prompt encoder
for boxes and the two-way-transformer mask decoder; no video memory.

Hiera-L: a 7x7/4 patch embedding, the background position embedding
resized from 7x7 by the cubic resize of ``jax.image.resize``
(``ops/image.resize_cubic``) plus the tiled window embedding; 48 blocks in
stages of 2, 6, 36 and 4, windowed (8, 4, 16, 8) apart from the three
global ones, and q-pooling (a 2x2 max-pool of the queries and of the
shortcut) at each stage's first block, which windows with the previous
stage's size. Head size 72 throughout; the attention is written out in plain
PyTorch, as in the reference.

Numerics copied from the reference: its LayerNorms are Flax's, whose
epsilon is 1e-6 (the trunk's and the decoder's; torch's default is 1e-5);
GELU is the exact one; the stability fallback of sam2.1 (token 0's mask,
else the multimask token of the best IoU where token 0's is unstable) and
the logits' upsampling by ``jax.image.resize``'s linear resize
(``ops/image.resize_linear``). Everything runs float32 (``Sam2Config.dtype``).
Convolutions (the patch embedding, the neck, the decoder's upscaling with its
two ConvTranspose layers) run NCHW on cuDNN; the trunk's blocks and the
decoder's tokens run NHWC / token-major as the reference's reshapes take them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from followmyhold_tpu_torch.models.hunyuan import LayerNormF32
from followmyhold_tpu_torch.ops.image import resize_cubic, resize_linear, resize_nearest

# Flax's LayerNorm epsilon, which the reference's nn.LayerNorm() takes
FLAX_LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class Sam2Config:
    # Hiera-L (sam2.1_hiera_l.yaml)
    image_size: int = 1024
    embed_dim: int = 144
    num_heads: int = 2                    # initial heads
    stages: Tuple[int, ...] = (2, 6, 36, 4)
    global_att_blocks: Tuple[int, ...] = (23, 33, 43)
    window_spec: Tuple[int, ...] = (8, 4, 16, 8)
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (7, 7)
    # neck
    d_model: int = 256
    backbone_channel_list: Tuple[int, ...] = (1152, 576, 288, 144)
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    scalp: int = 1
    # decoder
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_mask_tokens: int = 4              # 3 multimask + 1 single
    # the single-mask output falls back to the best multimask token when the
    # token-0 mask is unstable (sam2.1 dynamic_multimask_via_stability)
    dynamic_multimask_via_stability: bool = True
    stability_delta: float = 0.05
    stability_thresh: float = 0.98
    dtype: torch.dtype = torch.float32


SAM2_LARGE = Sam2Config()
SAM2_TINY_TEST = Sam2Config(
    image_size=128, embed_dim=16, num_heads=1, stages=(1, 1, 1, 1),
    global_att_blocks=(2,), window_spec=(4, 2, 4, 2),
    backbone_channel_list=(128, 64, 32, 16), d_model=32, decoder_depth=1,
    decoder_heads=2, decoder_mlp_dim=64)


def _window_partition(x: torch.Tensor, w: int):
    """[B, H, W, C] -> ([B * nw, w, w, C], the padded (Hp, Wp)); zero padding."""
    B, H, W, C = x.shape
    pad_h = (w - H % w) % w
    pad_w = (w - W % w) % w
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    win = x.reshape(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return win.reshape(-1, w, w, C), (Hp, Wp)


def _window_unpartition(win: torch.Tensor, w: int, pad_hw, hw) -> torch.Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    B = win.shape[0] // (Hp * Wp // w // w)
    x = win.reshape(B, Hp // w, Wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """A VALID 2x2/2 max-pool of [B, H, W, C]."""
    B, H, W, C = x.shape
    x = x[:, :H // 2 * 2, :W // 2 * 2]
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def _attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v on [B, h, N, d] in float32."""
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(logits.float(), dim=-1).to(v.dtype), v)


class HieraAttention(nn.Module):
    """Hiera's MultiScaleAttention: packed qkv, optional q-pooling."""

    def __init__(self, dim: int, dim_out: int, heads: int, q_pool: bool, dtype, device=None):
        super().__init__()
        self.dim_out, self.heads, self.q_pool = dim_out, heads, q_pool
        self.qkv = nn.Linear(dim, 3 * dim_out, dtype=dtype, device=device)
        self.proj = nn.Linear(dim_out, dim_out, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3, self.heads, -1)
        q, k, v = qkv.unbind(2)                                      # [B, HW, h, d]
        if self.q_pool:
            q = _max_pool_2x2(q.reshape(B, H, W, -1))
            H, W = H // 2, W // 2
            q = q.reshape(B, H * W, self.heads, -1)
        out = _attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return self.proj(out.transpose(1, 2).reshape(B, H, W, self.dim_out))


class HieraBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, heads: int, window_size: int, q_stride: int,
                 dtype, device=None):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.window_size, self.q_stride = window_size, q_stride
        self.norm1 = LayerNormF32(dim, True, dtype, device, eps=FLAX_LN_EPS)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out, dtype=dtype, device=device)
        self.attn = HieraAttention(dim, dim_out, heads, q_stride > 1, dtype, device)
        self.norm2 = LayerNormF32(dim_out, True, dtype, device, eps=FLAX_LN_EPS)
        self.mlp1 = nn.Linear(dim_out, 4 * dim_out, dtype=dtype, device=device)
        self.mlp2 = nn.Linear(4 * dim_out, dim_out, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        s = self.q_stride
        shortcut = x
        h = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = self.proj(h)
        if s > 1:
            shortcut = _max_pool_2x2(shortcut)
        w = self.window_size
        if w > 0:
            win, pad_hw = _window_partition(h, w)
            h = _window_unpartition(self.attn(win), w // s, (pad_hw[0] // s, pad_hw[1] // s),
                                    (H // s, W // s))
        else:
            h = self.attn(h)
        x = shortcut + h
        return x + self.mlp2(F.gelu(self.mlp1(self.norm2(x))))


class Hiera(nn.Module):
    """-> the four stage outputs NHWC (strides 4, 8, 16, 32), channels
    embed_dim * (1, 2, 4, 8)."""

    def __init__(self, cfg: Sam2Config, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.patch_embed = nn.Conv2d(3, c.embed_dim, 7, stride=4, padding=3, dtype=c.dtype,
                                     device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, *c.window_pos_embed_bkg_spatial_size, c.embed_dim, **f32))
        self.pos_embed_window = nn.Parameter(torch.zeros(
            1, c.window_spec[0], c.window_spec[0], c.embed_dim, **f32))
        ends = np.cumsum(c.stages)
        self.stage_ends = set((ends - 1).tolist())
        q_pool_blocks = set(ends[:-1].tolist())
        dim, heads, stage = c.embed_dim, c.num_heads, 0
        for i in range(int(ends[-1])):
            dim_out, q_stride = dim, 1
            if i in q_pool_blocks:
                dim_out, heads, q_stride = dim * 2, heads * 2, 2
                stage += 1
            # a stage's first block windows with the previous stage's size
            # (the partition comes before the pooling)
            wstage = stage - 1 if q_stride > 1 else stage
            wsize = 0 if i in c.global_att_blocks else c.window_spec[wstage]
            self.add_module(f"block{i}", HieraBlock(dim, dim_out, heads, wsize, q_stride,
                                                    c.dtype, device))
            dim = dim_out
        self.depth = int(ends[-1])

    def forward(self, x: torch.Tensor):
        c = self.cfg
        x = self.patch_embed(x.to(c.dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        h, w = x.shape[1:3]
        pos = resize_cubic(self.pos_embed, h, w)
        n = c.window_spec[0]
        wint = self.pos_embed_window.repeat(1, -(-h // n), -(-w // n), 1)[:, :h, :w]
        x = x + (pos + wint).to(c.dtype)
        outs = []
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
            if i in self.stage_ends:
                outs.append(x)
        return outs


def _sine_pos_2d(h: int, w: int, dim: int, temperature: float = 10000.0,
                 device=None) -> torch.Tensor:
    """SAM2's PositionEmbeddingSine (normalize=True, scale 2 pi) [h, w, dim]."""
    scale = 2 * math.pi
    eps = 1e-6
    y = (torch.arange(h, dtype=torch.float32, device=device) + 1.0) / (h + eps) * scale
    x = (torch.arange(w, dtype=torch.float32, device=device) + 1.0) / (w + eps) * scale
    half = dim // 2
    dim_t = torch.arange(half, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / half)

    def enc(v):
        p = v[:, None] / dim_t
        return torch.stack([torch.sin(p[:, 0::2]), torch.cos(p[:, 1::2])],
                           dim=-1).reshape(v.shape[0], -1)

    return torch.cat([enc(y)[:, None].expand(h, w, half),
                      enc(x)[None].expand(h, w, half)], dim=-1)


class FpnNeck(nn.Module):
    """SAM2's FpnNeck: a 1x1 conv to d_model per level (conv i takes
    backbone_channel_list[i], stride 32 first) and top-down nearest-upsampled
    adds on ``fpn_top_down_levels``; the stride-32 level dropped (scalp)."""

    def __init__(self, cfg: Sam2Config, device=None):
        super().__init__()
        c = self.cfg = cfg
        for i, ch in enumerate(c.backbone_channel_list):
            self.add_module(f"conv{i}", nn.Conv2d(ch, c.d_model, 1, dtype=c.dtype,
                                                  device=device))

    def forward(self, trunk_outs):
        """NHWC stage outputs -> (NCHW maps, NHWC-ordered positions [h, w, d])."""
        c = self.cfg
        n = len(trunk_outs)
        feats = [None] * n
        prev = None
        for i in range(n - 1, -1, -1):            # from the lowest resolution (stride 32)
            lateral = getattr(self, f"conv{n - 1 - i}")(trunk_outs[i].permute(0, 3, 1, 2))
            if i in c.fpn_top_down_levels and prev is not None:
                lateral = lateral + resize_nearest(prev, lateral.shape)
            prev = lateral
            feats[i] = lateral
        if c.scalp:
            feats = feats[:-1]
        poss = [_sine_pos_2d(f.shape[2], f.shape[3], c.d_model, device=f.device) for f in feats]
        return feats, poss


# --------------------------------------------------------------------------- #
# the prompt encoder and the mask decoder
# --------------------------------------------------------------------------- #

class PromptEncoder(nn.Module):
    """Box prompts only (the pipeline's predictor.predict(box=...))."""

    def __init__(self, cfg: Sam2Config, device=None):
        super().__init__()
        c = self.cfg = cfg
        f32 = dict(dtype=torch.float32, device=device)
        self.pe_gaussian = nn.Parameter(torch.zeros(2, c.d_model // 2, **f32))
        for name in ("point_embed_0", "point_embed_1", "point_embed_2", "point_embed_3",
                     "not_a_point_embed", "no_mask_embed"):
            setattr(self, name, nn.Parameter(torch.zeros(c.d_model, **f32)))

    def pe_encode(self, coords01: torch.Tensor) -> torch.Tensor:
        proj = 2 * math.pi * ((2.0 * coords01 - 1.0) @ self.pe_gaussian)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def forward(self, boxes01: torch.Tensor):
        """boxes01 [B, 4] in [0, 1] (x0, y0, x1, y1) -> sparse [B, 3, d] (the
        two corners and the not-a-point pad token of the image predictor's box
        path), dense (no mask) [d]."""
        p1 = self.pe_encode(boxes01[:, :2]) + self.point_embed_2
        p2 = self.pe_encode(boxes01[:, 2:]) + self.point_embed_3
        pad = self.not_a_point_embed.expand_as(p1)
        return torch.stack([p1, p2, pad], dim=1).to(self.cfg.dtype), self.no_mask_embed

    def dense_pe(self, h: int, w: int) -> torch.Tensor:
        dev = self.pe_gaussian.device
        gy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        gx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        yy, xx = torch.meshgrid(gy, gx, indexing="ij")
        return self.pe_encode(torch.stack([xx, yy], -1))               # [h, w, d]


class DecoderAttention(nn.Module):
    def __init__(self, d: int, heads: int, out_dim: int, dtype, device=None):
        super().__init__()
        self.heads, self.out_dim = heads, out_dim
        self.q_proj = nn.Linear(d, out_dim, dtype=dtype, device=device)
        self.k_proj = nn.Linear(d, out_dim, dtype=dtype, device=device)
        self.v_proj = nn.Linear(d, out_dim, dtype=dtype, device=device)
        self.out_proj = nn.Linear(out_dim, d, dtype=dtype, device=device)

    def forward(self, q, k, v):
        B, NQ, _ = q.shape
        hd = self.out_dim // self.heads

        def split(t):
            return t.reshape(B, -1, self.heads, hd).permute(0, 2, 1, 3)

        out = _attention(split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v)))
        return self.out_proj(out.permute(0, 2, 1, 3).reshape(B, NQ, self.out_dim))


class TwoWayBlock(nn.Module):
    def __init__(self, cfg: Sam2Config, skip_first_pe: bool, device=None):
        super().__init__()
        c = self.cfg = cfg
        d = c.d_model
        self.skip_first_pe = skip_first_pe
        self.self_attn = DecoderAttention(d, c.decoder_heads, d, c.dtype, device)
        self.cross_attn_token_to_image = DecoderAttention(d, c.decoder_heads, d // 2, c.dtype,
                                                          device)
        self.cross_attn_image_to_token = DecoderAttention(d, c.decoder_heads, d // 2, c.dtype,
                                                          device)
        for i in range(1, 5):
            self.add_module(f"norm{i}", LayerNormF32(d, True, c.dtype, device, eps=FLAX_LN_EPS))
        self.mlp1 = nn.Linear(d, c.decoder_mlp_dim, dtype=c.dtype, device=device)
        self.mlp2 = nn.Linear(c.decoder_mlp_dim, d, dtype=c.dtype, device=device)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_pe:
            # the first layer's attention replaces the queries (no residual)
            queries = self.self_attn(queries, queries, queries)
        else:
            qp = queries + query_pe
            queries = queries + self.self_attn(qp, qp, queries)
        queries = self.norm1(queries)
        qp = queries + query_pe
        kp = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(qp, kp, keys))
        queries = self.norm3(queries + self.mlp2(F.relu(self.mlp1(queries))))
        qp = queries + query_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(kp, qp, queries))
        return queries, keys


class MaskDecoder(nn.Module):
    def __init__(self, cfg: Sam2Config, device=None):
        super().__init__()
        c = self.cfg = cfg
        d, M = c.d_model, c.num_mask_tokens
        f32 = dict(dtype=torch.float32, device=device)
        self.iou_token = nn.Parameter(torch.zeros(1, d, **f32))
        self.mask_tokens = nn.Parameter(torch.zeros(M, d, **f32))
        self.obj_score_token = nn.Parameter(torch.zeros(1, d, **f32))
        for i in range(c.decoder_depth):
            self.add_module(f"block{i}", TwoWayBlock(c, i == 0, device))
        self.final_attn_token_to_image = DecoderAttention(d, c.decoder_heads, d // 2, c.dtype,
                                                          device)
        self.norm_final_attn = LayerNormF32(d, True, c.dtype, device, eps=FLAX_LN_EPS)
        kw = dict(dtype=c.dtype, device=device)
        self.upscale1 = nn.ConvTranspose2d(d, d // 4, 2, stride=2, **kw)
        self.conv_s1 = nn.Conv2d(d, d // 4, 1, **kw)
        self.upscale_norm = LayerNormF32(d // 4, True, c.dtype, device, eps=FLAX_LN_EPS)
        self.upscale2 = nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2, **kw)
        self.conv_s0 = nn.Conv2d(d, d // 8, 1, **kw)
        for t in range(M):
            for li, (din, dout) in enumerate(((d, d), (d, d), (d, d // 8))):
                self.add_module(f"hyper{t}_l{li}", nn.Linear(din, dout, **f32))
        for li, (din, dout) in enumerate(((d, d), (d, d), (d, M))):
            self.add_module(f"iou_l{li}", nn.Linear(din, dout, **f32))

    def forward(self, image_embed, image_pe, sparse_prompt, dense_prompt, feat_s0, feat_s1):
        """image_embed [B, d, h, w]; image_pe [h, w, d]; sparse [B, P, d];
        dense [d]; feat_s0/s1 the neck's stride-4 and stride-8 maps (NCHW).
        -> (mask logits [B, 4h, 4w, num_mask_tokens], iou [B, num_mask_tokens])."""
        c = self.cfg
        d, M = c.d_model, c.num_mask_tokens
        B, _, h, w = image_embed.shape
        tokens = torch.cat([self.obj_score_token, self.iou_token, self.mask_tokens], dim=0)
        tokens = torch.cat([tokens[None].expand(B, -1, -1), sparse_prompt], dim=1).to(c.dtype)
        src = (image_embed.permute(0, 2, 3, 1) + dense_prompt).reshape(B, h * w, d)
        pe = image_pe.reshape(1, h * w, d).expand(B, -1, -1).to(c.dtype)

        q, k = tokens, src
        for i in range(c.decoder_depth):
            q, k = getattr(self, f"block{i}")(q, k, tokens, pe)
        attn = self.final_attn_token_to_image(q + tokens, k + pe, k)
        q = self.norm_final_attn(q + attn)
        iou_out = q[:, 1]
        mask_toks = q[:, 2:2 + M]

        # upscale the image features x4, fusing the neck's high-resolution maps
        up = self.upscale1(k.reshape(B, h, w, d).permute(0, 3, 1, 2)) + self.conv_s1(feat_s1)
        up = self.upscale_norm(up.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        up = self.upscale2(F.gelu(up))
        up = F.gelu(up + self.conv_s0(feat_s0))                       # [B, d/8, 4h, 4w]

        hypers = []
        for t in range(M):
            x = mask_toks[:, t].float()
            for li in range(3):
                x = getattr(self, f"hyper{t}_l{li}")(x)
                if li < 2:
                    x = F.relu(x)
            hypers.append(x)
        hyper = torch.stack(hypers, dim=1)                            # [B, M, d/8]
        masks = torch.einsum("bmd,bdhw->bhwm", hyper, up.float())
        x = iou_out.float()
        for li in range(3):
            x = getattr(self, f"iou_l{li}")(x)
            if li < 2:
                x = F.relu(x)
        return masks, torch.sigmoid(x)          # sam2.1: iou_prediction_use_sigmoid


class Sam2(nn.Module):
    """Box-prompted segmentation: image [B, H, W, 3] in [0, 1] (normalised
    inside), boxes01 [B, 4] -> (mask logits at the input's size [B, H, W],
    iou scores [B])."""

    def __init__(self, cfg: Sam2Config, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.trunk = Hiera(c, device)
        self.neck = FpnNeck(c, device)
        self.prompt = PromptEncoder(c, device)
        self.decoder = MaskDecoder(c, device)
        # SAM2Base.no_mem_embed, added to the stride-16 embedding on the image
        # predictor's path (directly_add_no_mem_embed in sam2.1)
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, c.d_model, dtype=torch.float32,
                                                     device=device))

    def encode(self, image: torch.Tensor):
        dev = self.no_mem_embed.device
        mean = torch.tensor([0.485, 0.456, 0.406], device=dev)
        std = torch.tensor([0.229, 0.224, 0.225], device=dev)
        return self.neck(self.trunk((image.to(dev, torch.float32) - mean) / std))

    def forward(self, image: torch.Tensor, boxes01: torch.Tensor):
        c = self.cfg
        feats, _ = self.encode(image)
        feat_s0, feat_s1, image_embed = feats                 # strides 4, 8, 16
        image_embed = image_embed + self.no_mem_embed.reshape(1, -1, 1, 1).to(c.dtype)
        sparse, no_mask = self.prompt(boxes01.to(self.no_mem_embed.device))
        h, w = image_embed.shape[2:]
        masks, iou = self.decoder(image_embed, self.prompt.dense_pe(h, w), sparse,
                                  no_mask.to(c.dtype), feat_s0, feat_s1)
        # the single mask (token 0), or, where token 0's mask is unstable, the
        # multimask token of the best IoU (MaskDecoder._dynamic_multimask_via_stability)
        B = image.shape[0]
        logits = masks[..., 0]
        iou0 = iou[:, 0]
        if c.dynamic_multimask_via_stability:
            flat0 = logits.reshape(B, -1)
            area_i = torch.sum(flat0 > c.stability_delta, dim=-1).float()
            area_u = torch.sum(flat0 > -c.stability_delta, dim=-1).float()
            stability = torch.where(area_u > 0, area_i / torch.clamp(area_u, min=1.0),
                                    torch.ones_like(area_u))
            stable = stability >= c.stability_thresh
            best = torch.argmax(iou[:, 1:], dim=-1)                          # [B]
            mbest = torch.take_along_dim(masks[..., 1:], best[:, None, None, None],
                                         dim=-1)[..., 0]
            ibest = torch.take_along_dim(iou[:, 1:], best[:, None], dim=-1)[:, 0]
            logits = torch.where(stable[:, None, None], logits, mbest)
            iou0 = torch.where(stable, iou0, ibest)
        H, W = image.shape[1:3]
        return resize_linear(logits[..., None], H, W)[..., 0], iou0


def segment_box(model: Sam2, image_rgb: np.ndarray, box_xyxy: np.ndarray) -> np.ndarray:
    """predictor.predict(box=..., multimask_output=False): a bool mask at the
    image's resolution (the resizes are PIL's, on the host)."""
    from PIL import Image

    c = model.cfg
    H, W = image_rgb.shape[:2]
    img = Image.fromarray(image_rgb).resize((c.image_size, c.image_size))
    x = torch.from_numpy(np.asarray(img, np.float32) / 255.0)[None]
    box = np.asarray(box_xyxy, np.float32)
    scale = np.asarray([c.image_size / W, c.image_size / H] * 2, np.float32)
    box01 = (box * scale + 0.5) / c.image_size
    with torch.no_grad():
        logits, _ = model(x, torch.from_numpy(box01[None]))
    mask = logits[0].cpu().numpy() > 0.0
    mask_img = Image.fromarray(mask.astype(np.uint8) * 255).resize((W, H))
    return np.asarray(mask_img) > 127
