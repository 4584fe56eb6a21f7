"""HaMeR hand-mesh recovery in PyTorch: the ViT-H backbone and the
cross-attention MANO transformer-decoder head with iterative error feedback.

Counterpart of followmyhold_tpu/models/hamer.py. Module and parameter names
follow the Flax modules, so ``utils.params.flax_to_torch`` loads a Flax tree:
the head's scan-stacked layers (``mano_head/layers/layer/...``) land on
``mano_head.layers.<i>``. Per decoder layer: pre-LN self-attention,
cross-attention to the backbone's tokens and a GELU feed-forward, in bf16
with LayerNorm in float32; there is no final norm after the layers. The
readout (pose, betas, camera) runs in float32.

``hamer_forward`` is the reference's ``forward_step``: the network, the MANO
forward, the crop camera's translation 2f / (s b) and the projection of the
keypoints with the normalised focal f / image_size.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from followmyhold_tpu_torch.models.hunyuan import LayerNormF32, _merge_heads, _split_heads
from followmyhold_tpu_torch.models.mano import ManoModel, mano_forward
from followmyhold_tpu_torch.models.vit import HAMER_VIT_H, ViTConfig, ViTFeatureMap
from followmyhold_tpu_torch.ops.attention import multi_head_attention
from followmyhold_tpu_torch.ops.camera import perspective_projection
from followmyhold_tpu_torch.ops.rotations import rot6d_to_matrix

# the mean pose's 6d rotation of every joint (the identity) and the mean weak-
# perspective camera; converted checkpoints overwrite both
_IDENTITY_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)
_MEAN_CAM = (0.9, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class HamerConfig:
    backbone: ViTConfig = HAMER_VIT_H
    head_dim: int = 1024
    head_depth: int = 6
    head_heads: int = 8
    head_dim_head: int = 64
    head_mlp_dim: int = 1024
    context_dim: int = 1280
    ief_iters: int = 1
    num_hand_joints: int = 15
    image_size: int = 256
    focal_length: float = 5000.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def npose(self) -> int:
        return 6 * (self.num_hand_joints + 1)


class HamerOutput(NamedTuple):
    global_orient: torch.Tensor    # [B,1,3,3]
    hand_pose: torch.Tensor        # [B,15,3,3]
    betas: torch.Tensor            # [B,10]
    pred_cam: torch.Tensor         # [B,3] weak perspective (s, tx, ty)
    pred_cam_t: torch.Tensor       # [B,3] crop camera translation
    vertices: torch.Tensor         # [B,778,3]
    keypoints_3d: torch.Tensor     # [B,21,3]
    keypoints_2d: torch.Tensor     # [B,21,2] normalised crop coordinates
    focal_length: torch.Tensor     # [B,2]


def _attend(q, k, v, heads: int) -> torch.Tensor:
    out = multi_head_attention(_split_heads(q, heads), _split_heads(k, heads),
                               _split_heads(v, heads), device=q.device)
    return _merge_heads(out)


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(dim, inner, bias=False, dtype=dtype, device=device)
        self.to_kv = nn.Linear(context_dim, 2 * inner, bias=False, dtype=dtype, device=device)
        self.to_out = nn.Linear(inner, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        k, v = self.to_kv(context).chunk(2, dim=-1)
        return self.to_out(_attend(self.to_q(x), k, v, self.heads))


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, dtype: torch.dtype, device=None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False, dtype=dtype, device=device)
        self.to_out = nn.Linear(inner, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        return self.to_out(_attend(q, k, v, self.heads))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: HamerConfig, device=None):
        super().__init__()
        c = cfg
        self.norm_sa = LayerNormF32(c.head_dim, True, c.dtype, device)
        self.sa = SelfAttention(c.head_dim, c.head_heads, c.head_dim_head, c.dtype, device)
        self.norm_ca = LayerNormF32(c.head_dim, True, c.dtype, device)
        self.ca = CrossAttention(c.head_dim, c.context_dim, c.head_heads, c.head_dim_head,
                                 c.dtype, device)
        self.norm_ff = LayerNormF32(c.head_dim, True, c.dtype, device)
        self.ff1 = nn.Linear(c.head_dim, c.head_mlp_dim, dtype=c.dtype, device=device)
        self.ff2 = nn.Linear(c.head_mlp_dim, c.head_dim, dtype=c.dtype, device=device)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.sa(self.norm_sa(x))
        x = x + self.ca(self.norm_ca(x), context)
        return x + self.ff2(F.gelu(self.ff1(self.norm_ff(x))))


class ManoHead(nn.Module):
    """MANOTransformerDecoderHead: a zero input token, embedded, plus a
    learned position embedding, cross-attends to the backbone's tokens; the
    readout adds to the mean pose, betas and camera."""

    def __init__(self, cfg: HamerConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        f32 = torch.float32
        self.init_hand_pose = nn.Parameter(torch.zeros((1, c.npose), dtype=f32, device=device))
        self.init_betas = nn.Parameter(torch.zeros((1, 10), dtype=f32, device=device))
        self.init_cam = nn.Parameter(torch.zeros((1, 3), dtype=f32, device=device))
        self.pos_embedding = nn.Parameter(torch.zeros((1, 1, c.head_dim), dtype=f32,
                                                      device=device))
        self.input_proj = nn.Linear(1, c.head_dim, dtype=c.dtype, device=device)
        self.layers = nn.ModuleList(DecoderLayer(c, device) for _ in range(c.head_depth))
        self.decpose = nn.Linear(c.head_dim, c.npose, dtype=f32, device=device)
        self.decshape = nn.Linear(c.head_dim, 10, dtype=f32, device=device)
        self.deccam = nn.Linear(c.head_dim, 3, dtype=f32, device=device)
        self.reset_mean_params_()

    def reset_mean_params_(self) -> None:
        """The mean pose (identity rotations), zero betas and the mean camera."""
        c = self.cfg
        with torch.no_grad():
            self.init_hand_pose.copy_(self.init_hand_pose.new_tensor(_IDENTITY_6D).repeat(
                c.num_hand_joints + 1)[None])
            self.init_betas.zero_()
            self.init_cam.copy_(self.init_cam.new_tensor([_MEAN_CAM]))

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        c = self.cfg
        B = tokens.shape[0]
        pred_pose = self.init_hand_pose.expand(B, -1)
        pred_betas = self.init_betas.expand(B, -1)
        pred_cam = self.init_cam.expand(B, -1)
        for _ in range(c.ief_iters):
            token = tokens.new_zeros((B, 1, 1), dtype=c.dtype)
            x = self.input_proj(token) + self.pos_embedding.to(c.dtype)
            for layer in self.layers:
                x = layer(x, tokens)
            token_out = x[:, 0].float()
            pred_pose = self.decpose(token_out) + pred_pose
            pred_betas = self.decshape(token_out) + pred_betas
            pred_cam = self.deccam(token_out) + pred_cam
        rotmats = rot6d_to_matrix(pred_pose.reshape(B, c.num_hand_joints + 1, 6))
        return rotmats[:, :1], rotmats[:, 1:], pred_betas, pred_cam


class Hamer(nn.Module):
    def __init__(self, cfg: HamerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = ViTFeatureMap(cfg.backbone, device)
        self.mano_head = ManoHead(cfg, device)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """images [B, S, S, 3] normalised crops -> (global_orient, hand_pose,
        betas, pred_cam). The columns are centre-cut to the backbone's width:
        256 -> 192 at full size, as the reference's fixed 32-column cut."""
        cut = (images.shape[2] - self.cfg.backbone.img_size[1]) // 2
        feats = self.backbone(images[:, :, cut:images.shape[2] - cut, :])
        B, gh, gw, C = feats.shape
        return self.mano_head(feats.reshape(B, gh * gw, C))


def hamer_forward(model: Hamer, mano_model: ManoModel, images: torch.Tensor) -> HamerOutput:
    """The reference's forward_step: network, MANO forward, projection."""
    c = model.cfg
    B = images.shape[0]
    global_orient, hand_pose, betas, pred_cam = model(images)
    focal = torch.full((B, 2), c.focal_length, dtype=torch.float32, device=images.device)
    pred_cam_t = torch.stack([
        pred_cam[:, 1], pred_cam[:, 2],
        2.0 * focal[:, 0] / (c.image_size * pred_cam[:, 0] + 1e-9)], dim=-1)
    mano_out = mano_forward(mano_model, global_orient, hand_pose, betas)
    kps2d = perspective_projection(mano_out.joints, translation=pred_cam_t,
                                   focal_length=focal / c.image_size)
    return HamerOutput(global_orient=global_orient, hand_pose=hand_pose, betas=betas,
                       pred_cam=pred_cam, pred_cam_t=pred_cam_t, vertices=mano_out.vertices,
                       keypoints_3d=mano_out.joints, keypoints_2d=kps2d, focal_length=focal)
