"""The hand-object detector (Faster R-CNN, ResNet-101, contact extension) in
PyTorch.

Counterpart of followmyhold_tpu/models/hand_object_detector.py, the port of
the original hand_object_detector (lib/model/faster_rcnn, lib/model/rpn,
lib/model/extension_layers):

- a Caffe-style ResNet-101 (the stride on each first bottleneck's 1x1
  conv1), its frozen BatchNorms folded into the conv biases at conversion;
  the trunk is conv1 to layer3 (stride 16, 1024 channels) and runs in
  ``FrcnnConfig.dtype`` (bf16 at the published config);
- the RPN in float32: a 3x3 conv to 512, a 2-class softmax objectness and
  4 deltas per anchor over the classic anchor grid (scales 4/8/16/32, ratios
  0.5/1/2); the top ``pre_nms_top_n`` proposals by a stable descending sort
  (``jax.lax.top_k``'s order: the lower index first on ties), NMS at 0.7 to
  at most ``post_nms_top_n`` rois;
- ROIAlign 7x7 on the stride-16 map, layer4, the spatial mean, then the
  heads: class scores (background / target object / hand), per-class box
  deltas and the extension's contact state, hand-to-object offset and side.

The convolutions run NCHW on cuDNN. The RPN's outputs are taken in NHWC order
before the reference's reshapes: (gh, gw, 2, na) for the objectness, so
channel c is (class c // na, anchor c % na), and (gh * gw * na, 4) for the
deltas. The stem pads with -inf before its VALID 3x3/2 max-pool, as there.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from followmyhold_tpu_torch.ops.nms import nms, roi_align
from followmyhold_tpu_torch.ops.safe import safe_normalize


@dataclasses.dataclass(frozen=True)
class FrcnnConfig:
    width: int = 64
    stage_blocks: Tuple[int, ...] = (3, 4, 23, 3)   # ResNet-101
    feat_stride: int = 16
    num_classes: int = 3
    anchor_scales: Tuple[int, ...] = (4, 8, 16, 32)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    roi_size: int = 7
    pre_nms_top_n: int = 6000
    post_nms_top_n: int = 300
    rpn_nms_thresh: float = 0.7
    dtype: torch.dtype = torch.bfloat16


FRCNN_TINY = FrcnnConfig(width=8, stage_blocks=(1, 1, 1, 1),
                         pre_nms_top_n=64, post_nms_top_n=16,
                         dtype=torch.float32)


class FusedConv(nn.Module):
    """Conv with bias (the frozen BN folded in at conversion)."""

    def __init__(self, cin: int, ch: int, k: int, stride: int, dtype, device=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, ch, k, stride=stride, padding=k // 2, dtype=dtype,
                              device=device)

    def forward(self, x):
        return self.conv(x)


class Bottleneck(nn.Module):
    """Caffe-style: the stride on conv1."""

    def __init__(self, cin: int, planes: int, stride: int, has_downsample: bool, dtype,
                 device=None):
        super().__init__()
        self.conv1 = FusedConv(cin, planes, 1, stride, dtype, device)
        self.conv2 = FusedConv(planes, planes, 3, 1, dtype, device)
        self.conv3 = FusedConv(planes, planes * 4, 1, 1, dtype, device)
        self.downsample = (FusedConv(cin, planes * 4, 1, stride, dtype, device)
                           if has_downsample else None)

    def forward(self, x):
        h = F.relu(self.conv1(x))
        h = F.relu(self.conv2(h))
        h = self.conv3(h)
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(h + x)


class ResNetStage(nn.Module):
    def __init__(self, cin: int, planes: int, blocks: int, stride: int, dtype, device=None):
        super().__init__()
        self.blocks = blocks
        for b in range(blocks):
            need_down = b == 0 and (stride != 1 or cin != planes * 4)
            self.add_module(f"block{b}", Bottleneck(cin if b == 0 else planes * 4, planes,
                                                    stride if b == 0 else 1, need_down, dtype,
                                                    device))

    def forward(self, x):
        for b in range(self.blocks):
            x = getattr(self, f"block{b}")(x)
        return x


def generate_anchors(base_size=16, ratios=(0.5, 1.0, 2.0),
                     scales=(4, 8, 16, 32)) -> np.ndarray:
    """Classic Faster R-CNN anchors (lib/model/rpn/generate_anchors.py): the
    ratios with integer rounding, then the scales about the base anchor's
    centre. [len(ratios) * len(scales), 4] float32."""
    base = np.array([0, 0, base_size - 1, base_size - 1], np.float32)

    def whctrs(a):
        w = a[2] - a[0] + 1
        h = a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mkanchors(ws, hs, x_ctr, y_ctr):
        ws = ws[:, None]
        hs = hs[:, None]
        return np.hstack([x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                          x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)])

    w, h, xc, yc = whctrs(base)
    size = w * h
    size_ratios = size / np.asarray(ratios)
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * np.asarray(ratios))
    ratio_anchors = mkanchors(ws, hs, xc, yc)
    out = []
    for i in range(ratio_anchors.shape[0]):
        w, h, xc, yc = whctrs(ratio_anchors[i])
        ws = w * np.asarray(scales, np.float32)
        hs = h * np.asarray(scales, np.float32)
        out.append(mkanchors(ws, hs, xc, yc))
    return np.vstack(out).astype(np.float32)


def shift_anchors(anchors: np.ndarray, gh: int, gw: int, stride: int) -> np.ndarray:
    """The anchors at every cell of a gh x gw map: [gh * gw * na, 4],
    position-major with the anchor innermost."""
    sx = np.arange(gw) * stride
    sy = np.arange(gh) * stride
    xx, yy = np.meshgrid(sx, sy)
    shifts = np.stack([xx.ravel(), yy.ravel(), xx.ravel(), yy.ravel()], axis=1)
    all_a = anchors[None] + shifts[:, None].astype(np.float32)
    return all_a.reshape(-1, 4)


def decode_deltas(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """bbox_transform_inv (lib/model/rpn/bbox_transform.py); this fork does
    not subtract 1 at x2/y2, so the corners are symmetric about the centre."""
    wa = anchors[:, 2] - anchors[:, 0] + 1.0
    ha = anchors[:, 3] - anchors[:, 1] + 1.0
    cxa = anchors[:, 0] + 0.5 * wa
    cya = anchors[:, 1] + 0.5 * ha
    dx, dy, dw, dh = deltas[:, 0], deltas[:, 1], deltas[:, 2], deltas[:, 3]
    cx = dx * wa + cxa
    cy = dy * ha + cya
    w = torch.exp(torch.clamp(dw, -5, 5)) * wa
    h = torch.exp(torch.clamp(dh, -5, 5)) * ha
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


class HandObjectDetector(nn.Module):
    def __init__(self, cfg: FrcnnConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        na = len(c.anchor_scales) * len(c.anchor_ratios)
        w, d = c.width, c.dtype
        self.conv1 = FusedConv(3, w, 7, 2, d, device)
        self.layer1 = ResNetStage(w, w, c.stage_blocks[0], 1, d, device)
        self.layer2 = ResNetStage(4 * w, 2 * w, c.stage_blocks[1], 2, d, device)
        self.layer3 = ResNetStage(8 * w, 4 * w, c.stage_blocks[2], 2, d, device)
        self.rpn_conv = nn.Conv2d(16 * w, 512, 3, padding=1, dtype=torch.float32, device=device)
        self.rpn_cls = nn.Conv2d(512, 2 * na, 1, dtype=torch.float32, device=device)
        self.rpn_box = nn.Conv2d(512, 4 * na, 1, dtype=torch.float32, device=device)
        self.layer4 = ResNetStage(16 * w, 8 * w, c.stage_blocks[3], 2, d, device)
        f32 = dict(dtype=torch.float32, device=device)
        self.cls_score = nn.Linear(32 * w, c.num_classes, **f32)
        self.bbox_pred = nn.Linear(32 * w, 4 * c.num_classes, **f32)
        self.ext_contact1 = nn.Linear(32 * w, 32, **f32)
        self.ext_contact2 = nn.Linear(32, 5, **f32)
        self.ext_dydx = nn.Linear(32 * w, 3, **f32)
        self.ext_lr = nn.Linear(32 * w, 1, **f32)
        self.base_anchors = generate_anchors(c.feat_stride, c.anchor_ratios, c.anchor_scales)
        self._anchors = {}       # (gh, gw, device) -> the shifted anchors there

    def trunk(self, image: torch.Tensor) -> torch.Tensor:
        """[H, W, 3] -> the stride-16 map [1, 16 * width, gh, gw] (RCNN_base)."""
        c = self.cfg
        x = image.to(self.conv1.conv.weight.device, c.dtype).permute(2, 0, 1)[None]
        x = F.relu(self.conv1(x))
        x = F.pad(x, (1, 1, 1, 1), value=-float("inf"))
        x = F.max_pool2d(x, 3, stride=2)
        return self.layer3(self.layer2(self.layer1(x)))

    def proposals(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The RPN on the stride-16 map -> the top proposals, score-sorted,
        clipped to the image: (boxes [K, 4], fg scores [K])."""
        c = self.cfg
        na = len(c.anchor_scales) * len(c.anchor_ratios)
        _, _, gh, gw = feat.shape
        rpn = F.relu(self.rpn_conv(feat.float()))
        cls_logits = self.rpn_cls(rpn)[0].permute(1, 2, 0)           # [gh, gw, 2 na]
        box_deltas = self.rpn_box(rpn)[0].permute(1, 2, 0)           # [gh, gw, 4 na]
        probs = torch.softmax(cls_logits.reshape(gh, gw, 2, na), dim=2)[..., 1, :]
        scores = probs.reshape(-1)
        deltas = box_deltas.reshape(-1, 4)
        key = (gh, gw, feat.device)
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(shift_anchors(
                self.base_anchors, gh, gw, c.feat_stride)).to(feat.device)
        anchors = self._anchors[key]
        boxes = decode_deltas(anchors, deltas)
        H, W = gh * c.feat_stride, gw * c.feat_stride
        lim = torch.tensor([W - 1, H - 1, W - 1, H - 1], dtype=torch.float32,
                           device=feat.device)
        boxes = torch.minimum(torch.clamp(boxes, min=0.0), lim)
        top = min(c.pre_nms_top_n, boxes.shape[0])
        top_scores, top_idx = torch.sort(scores, descending=True, stable=True)
        top_scores, top_idx = top_scores[:top], top_idx[:top]
        return boxes[top_idx], top_scores

    def forward(self, image: torch.Tensor) -> dict:
        """image: [H, W, 3] BGR, the pixel means subtracted (``preprocess_image``).
        Returns the per-roi predictions (``post_nms_top_n`` rois, zero-padded)."""
        c = self.cfg
        feat = self.trunk(image)
        top_boxes, top_scores = self.proposals(feat)
        dev = feat.device
        keep = nms(top_boxes, top_scores, c.rpn_nms_thresh, max_out=c.post_nms_top_n)
        n_roi = c.post_nms_top_n
        rank = torch.cumsum(keep.to(torch.int32), 0) - 1
        slots = torch.where(keep, rank, torch.full_like(rank, n_roi)).long()
        rois = torch.zeros(n_roi + 1, 4, device=dev).index_put_((slots,), top_boxes)[:-1]
        roi_scores = torch.zeros(n_roi + 1, device=dev).index_put_((slots,), top_scores)[:-1]

        # ROIAlign 7x7 -> layer4 -> the spatial mean (_head_to_tail)
        pooled = roi_align(feat[0].float().permute(1, 2, 0), rois / c.feat_stride,
                           (c.roi_size, c.roi_size))
        h = self.layer4(pooled.to(c.dtype).permute(0, 3, 1, 2))
        h = h.float().mean(dim=(2, 3)).to(c.dtype).float()          # [N, 32 * width]

        cls_logits = self.cls_score(h)
        contact = self.ext_contact2(F.relu(self.ext_contact1(h)))
        dydx = self.ext_dydx(h)
        offset = torch.cat([dydx[:, :1], 0.1 * safe_normalize(dydx[:, 1:])], dim=-1)
        return {
            "rois": rois,
            "roi_scores": roi_scores,
            "cls_probs": torch.softmax(cls_logits, dim=-1),
            "bbox_deltas": self.bbox_pred(h),
            "contact_state": torch.softmax(contact, dim=-1),
            "offset": offset,            # [N, 3]: magnitude, dx, dy
            "hand_side": torch.sigmoid(self.ext_lr(h)[:, 0]),
        }


PIXEL_MEANS_BGR = np.array([102.9801, 115.9465, 122.7717], np.float32)


def preprocess_image(image_rgb: np.ndarray, target: int = 600, max_size: int = 1000):
    """hoi_detector.py's test-time pipeline on the host: BGR, the means
    subtracted, the short side to 600 with the long side at most 1000.
    Returns (blob [H, W, 3] float32, scale)."""
    from PIL import Image

    H, W = image_rgb.shape[:2]
    scale = target / min(H, W)
    if scale * max(H, W) > max_size:
        scale = max_size / max(H, W)
    nh, nw = int(round(H * scale)), int(round(W * scale))
    img = np.asarray(Image.fromarray(image_rgb).resize((nw, nh)), np.float32)
    bgr = img[..., ::-1] - PIXEL_MEANS_BGR
    return bgr, scale


def match_hands_to_objects(obj_boxes: np.ndarray, hand_boxes: np.ndarray,
                           contact: np.ndarray, offsets: np.ndarray) -> List[int]:
    """filter_object (hoi_detector.py:179-195): each hand in contact takes the
    object whose centre is nearest to the hand's centre + 1000 * scaled offset;
    -1 for a hand out of contact or without objects."""
    out = []
    for i in range(len(hand_boxes)):
        if contact[i] <= 0:
            out.append(-1)
            continue
        hc = np.array([(hand_boxes[i, 0] + hand_boxes[i, 2]) / 2,
                       (hand_boxes[i, 1] + hand_boxes[i, 3]) / 2])
        point = hc + 1000.0 * offsets[i, 0] * offsets[i, 1:]
        if len(obj_boxes) == 0:
            out.append(-1)
            continue
        oc = np.stack([(obj_boxes[:, 0] + obj_boxes[:, 2]) / 2,
                       (obj_boxes[:, 1] + obj_boxes[:, 3]) / 2], axis=1)
        out.append(int(np.argmin(np.linalg.norm(oc - point, axis=1))))
    return out


def detect_hand_object(model: HandObjectDetector, image_rgb: np.ndarray, thresh: float = 0.5):
    """-> (union object box, union hand box) in image pixels, either None
    where no roi of its class passes ``thresh``: the hand_object_detector(image)
    contract (hoi_detector.py:204-452)."""
    blob, scale = preprocess_image(image_rgb)
    with torch.no_grad():
        out = model(torch.from_numpy(np.ascontiguousarray(blob)))
    rois = out["rois"].cpu().numpy() / scale
    probs = out["cls_probs"].cpu().numpy()
    deltas = out["bbox_deltas"].cpu().numpy()

    def union(cls_id):
        # the per-class refined boxes: bbox_pred with the test-time stds
        stds = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
        d = deltas[:, 4 * cls_id:4 * (cls_id + 1)] * stds
        boxes = decode_deltas(torch.from_numpy(rois * scale),
                              torch.from_numpy(d)).numpy() / scale
        sel = probs[:, cls_id] > thresh
        if not sel.any():
            return None
        b = boxes[sel]
        return np.array([b[:, 0].min(), b[:, 1].min(), b[:, 2].max(), b[:, 3].max()],
                        np.float32)

    return union(1), union(2)     # target object, hand
