"""ViTPose wholebody keypoints in PyTorch: the ViT backbone and the classic
top-down head of two transposed convolutions.

Counterpart of followmyhold_tpu/models/vitpose.py. The published model is
ViTPose+-H wholebody: HaMeR's ViT-H (``models/vit.py`` with 2 px of patch
padding and the position embedding's cls slot added to every token; 1280 wide,
32 deep, 16 heads, a 256x192 input), then two 4x4, stride-2 transposed
convolutions of 256 channels, each followed by the checkpoint's BatchNorm
folded into a per-channel affine (``bn{i}_scale``, ``bn{i}_bias``, the Flax
names) and a ReLU, and a 1x1 convolution to 133 heatmaps in float32 at a
quarter of the input's size. About 0.63 B parameters, bf16.

Two things of Flax's ``ConvTranspose`` are kept: its ``SAME`` padding, which
for a 4x4 kernel at stride 2 pads the dilated input by 2 on each side (torch's
``padding=1``), and its kernel applied flipped in space, which
``utils.params.flax_to_torch`` flips back for every ``nn.ConvTranspose2d``.
The backbone's 192 tokens are under the flash kernel's 256, so its attention
is the plain one, as in the reference.

The hand stage takes the hand boxes from the wholebody keypoint blocks as the
reference does: indices 91-111 the left hand, 112-132 the right, a block valid
with more than 3 keypoints over the confidence threshold, its box the
keypoints' extent.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from followmyhold_tpu_torch.models.vit import HAMER_VIT_H, ViT, ViTConfig
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device
from followmyhold_tpu_torch.utils.params import init_random_, load_or_init

# COCO-wholebody layout (133 keypoints)
NUM_WHOLEBODY_KPS = 133
LEFT_HAND_SLICE = slice(91, 112)
RIGHT_HAND_SLICE = slice(112, 133)


@dataclasses.dataclass(frozen=True)
class ViTPoseConfig:
    backbone: ViTConfig = HAMER_VIT_H
    num_keypoints: int = NUM_WHOLEBODY_KPS
    deconv_channels: int = 256
    num_deconv: int = 2
    dtype: torch.dtype = torch.bfloat16


VITPOSE_TINY = ViTPoseConfig(
    backbone=ViTConfig(img_size=(64, 48), patch_size=16, embed_dim=32, depth=1, num_heads=2,
                       patch_padding=2, pos_embed_cls_slot=True, dtype=torch.float32),
    deconv_channels=16, dtype=torch.float32)


class ViTPose(nn.Module):
    """images [B,H,W,3] (ImageNet-normalised) -> heatmaps [B, H/4, W/4, K]
    float32, channels last as in the reference."""

    def __init__(self, cfg: ViTPoseConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.backbone = ViT(c.backbone, device)
        width = c.backbone.embed_dim
        for i in range(c.num_deconv):
            setattr(self, f"deconv{i}", nn.ConvTranspose2d(
                width if i == 0 else c.deconv_channels, c.deconv_channels, 4, stride=2,
                padding=1, dtype=c.dtype, device=device))
            self.register_parameter(f"bn{i}_scale", nn.Parameter(torch.ones(
                c.deconv_channels, dtype=torch.float32, device=device)))
            self.register_parameter(f"bn{i}_bias", nn.Parameter(torch.zeros(
                c.deconv_channels, dtype=torch.float32, device=device)))
        self.final = nn.Conv2d(c.deconv_channels, c.num_keypoints, 1, dtype=torch.float32,
                               device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, H, W, _ = images.shape
        gh, gw = H // c.backbone.patch_size, W // c.backbone.patch_size
        tokens = self.backbone(images)                                   # [B, gh*gw, C]
        x = tokens.reshape(B, gh, gw, -1).permute(0, 3, 1, 2).to(c.dtype)  # NCHW
        for i in range(c.num_deconv):
            x = getattr(self, f"deconv{i}")(x).float()
            scale = getattr(self, f"bn{i}_scale")[:, None, None]
            bias = getattr(self, f"bn{i}_bias")[:, None, None]
            x = F.relu(x * scale + bias).to(c.dtype)
        return self.final(x.float()).permute(0, 2, 3, 1)


def build_vitpose(cfg: Optional[ViTPoseConfig] = None, seed: int = 0,
                  device: DeviceLike = "cuda") -> ViTPose:
    """ViTPose on ``device`` in eval mode, without gradients to the weights:
    the converted checkpoint ``vitpose`` where its file exists, else seeded
    random weights (the folded BatchNorms then the identity)."""
    model = ViTPose(cfg or ViTPoseConfig(), device=resolve_device(device))
    model = load_or_init("vitpose", model, lambda m: init_random_(m, seed))
    return model.eval().requires_grad_(False)


def heatmaps_to_keypoints(heatmaps: torch.Tensor, image_hw: Tuple[int, int]) -> torch.Tensor:
    """[B,h,w,K] -> [B,K,3] (x, y, confidence) in image pixels: each
    heatmap's argmax (the first of equal maxima, as ``jnp.argmax``)."""
    B, h, w, K = heatmaps.shape
    flat = heatmaps.reshape(B, h * w, K)
    conf = flat.amax(dim=1)
    idx = flat.argmax(dim=1)
    yy = torch.div(idx, w, rounding_mode="floor").float() * (image_hw[0] / h)
    xx = (idx % w).float() * (image_hw[1] / w)
    return torch.stack([xx, yy, conf], dim=-1)


def hand_candidates_from_wholebody(kps: np.ndarray, conf_thresh: float = 0.5):
    """Keypoint blocks -> [(box_xyxy, score, is_right), ...] for both sides;
    the score is the mean confidence of the block's valid keypoints (it feeds
    the per-side NMS of multi-person frames)."""
    out = []
    for sl, is_right in ((LEFT_HAND_SLICE, False), (RIGHT_HAND_SLICE, True)):
        block = kps[sl]
        valid = block[:, 2] > conf_thresh
        if valid.sum() > 3:
            pts = block[valid, :2]
            box = np.array([pts[:, 0].min(), pts[:, 1].min(),
                            pts[:, 0].max(), pts[:, 1].max()], np.float32)
            out.append((box, float(block[valid, 2].mean()), is_right))
    return out


def hand_bboxes_from_wholebody(kps: np.ndarray, conf_thresh: float = 0.5):
    """Keypoint blocks -> (left_box, right_box), each xyxy or None where the
    block has 3 or fewer confident keypoints."""
    boxes = {is_right: box for box, _, is_right in
             hand_candidates_from_wholebody(kps, conf_thresh)}
    return boxes.get(False), boxes.get(True)
