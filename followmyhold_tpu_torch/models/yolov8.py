"""YOLOv8 detection graph in PyTorch: the WiLoR hand detector.

Counterpart of followmyhold_tpu/models/yolov8.py (the ultralytics YOLOv8
detect architecture; the checkpoint's Conv+BN pairs are fused at
conversion, so every conv carries its bias). Stem and four stages of
Conv/C2f, SPPF, the PAN-FPN (two nearest 2x upsamplings, two strided convs)
and the anchor-free Detect head with the DFL box decode (a softmax over 16
bins a side, their expectation) at strides 8, 16 and 32; the classes are the
hand's side (class 1 = right).

The convolutions run NCHW on cuDNN; the reference's NHWC reshapes (the DFL
bins, the flattened anchor grid) take the head's outputs in NHWC order, so
anchors come out row-major over (y, x) with the sides and bins innermost, as
there. Module names follow the Flax modules, so ``utils.params.flax_to_torch``
loads a Flax tree.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from followmyhold_tpu_torch.ops.image import resize_nearest


@dataclasses.dataclass(frozen=True)
class YoloV8Config:
    base_width: int = 16          # n=16, s=32, m=48(w0.75 cap768), l=64, x=80
    depth_mult: float = 0.33      # n/s=0.33, m=0.67, l/x=1.0
    max_channels: int = 1024      # n/s: 1024; m: 768; l: 512; x: 512
    num_classes: int = 2          # WiLoR: left / right hand
    reg_max: int = 16
    image_size: int = 640
    dtype: torch.dtype = torch.float32

    def ch(self, mult: int) -> int:
        return int(min(self.base_width * mult, self.max_channels
                       * self.base_width / 64 * 4))

    def n_rep(self, n: int) -> int:
        return max(round(n * self.depth_mult), 1)


YOLOV8_N = YoloV8Config()
YOLOV8_TINY_TEST = YoloV8Config(base_width=8, depth_mult=0.34, image_size=64)


class ConvBN(nn.Module):
    """ultralytics Conv (conv + BN + SiLU), the BN folded into the conv's bias."""

    def __init__(self, cin: int, ch: int, k: int, s: int, dtype, device=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, ch, k, stride=s, padding=k // 2, dtype=dtype, device=device)

    def forward(self, x):
        return F.silu(self.conv(x))


class Bottleneck(nn.Module):
    def __init__(self, ch: int, shortcut: bool, dtype, device=None):
        super().__init__()
        self.shortcut = shortcut
        self.cv1 = ConvBN(ch, ch, 3, 1, dtype, device)
        self.cv2 = ConvBN(ch, ch, 3, 1, dtype, device)

    def forward(self, x):
        h = self.cv2(self.cv1(x))
        return x + h if self.shortcut else h


class C2f(nn.Module):
    def __init__(self, cin: int, ch_out: int, n: int, shortcut: bool, dtype, device=None):
        super().__init__()
        c = ch_out // 2
        self.n = n
        self.cv1 = ConvBN(cin, 2 * c, 1, 1, dtype, device)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c, shortcut, dtype, device))
        self.cv2 = ConvBN((2 + n) * c, ch_out, 1, 1, dtype, device)

    def forward(self, x):
        parts = list(torch.chunk(self.cv1(x), 2, dim=1))
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    def __init__(self, cin: int, ch: int, dtype, device=None):
        super().__init__()
        self.cv1 = ConvBN(cin, ch // 2, 1, 1, dtype, device)
        self.cv2 = ConvBN(ch // 2 * 4, ch, 1, 1, dtype, device)

    def forward(self, x):
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(F.max_pool2d(outs[-1], 5, stride=1, padding=2))
        return self.cv2(torch.cat(outs, dim=1))


class DetectHead(nn.Module):
    def __init__(self, cfg: YoloV8Config, channels: Sequence[int], device=None):
        super().__init__()
        c = self.cfg = cfg
        self.levels = len(channels)
        c2 = max(16, channels[0] // 4, c.reg_max * 4)
        c3 = max(channels[0], min(c.num_classes, 100))
        for i, ch in enumerate(channels):
            self.add_module(f"cv2_{i}_0", ConvBN(ch, c2, 3, 1, c.dtype, device))
            self.add_module(f"cv2_{i}_1", ConvBN(c2, c2, 3, 1, c.dtype, device))
            self.add_module(f"cv2_{i}_2", nn.Conv2d(c2, 4 * c.reg_max, 1, dtype=torch.float32,
                                                    device=device))
            self.add_module(f"cv3_{i}_0", ConvBN(ch, c3, 3, 1, c.dtype, device))
            self.add_module(f"cv3_{i}_1", ConvBN(c3, c3, 3, 1, c.dtype, device))
            self.add_module(f"cv3_{i}_2", nn.Conv2d(c3, c.num_classes, 1, dtype=torch.float32,
                                                    device=device))

    def forward(self, feats) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        box_out, cls_out = [], []
        for i, f in enumerate(feats):
            b = getattr(self, f"cv2_{i}_1")(getattr(self, f"cv2_{i}_0")(f))
            b = getattr(self, f"cv2_{i}_2")(b.float())
            q = getattr(self, f"cv3_{i}_1")(getattr(self, f"cv3_{i}_0")(f))
            q = getattr(self, f"cv3_{i}_2")(q.float())
            box_out.append(b)
            cls_out.append(q)
        return box_out, cls_out


class YoloV8(nn.Module):
    """[B, H, W, 3] in [0, 1] -> (boxes [B, N, 4] xyxy px, scores [B, N, nc])."""

    def __init__(self, cfg: YoloV8Config, device=None):
        super().__init__()
        c = self.cfg = cfg
        w, d = c.base_width, c.dtype
        c5 = min(16 * w, c.max_channels)
        self.m0 = ConvBN(3, w, 3, 2, d, device)                          # P1
        self.m1 = ConvBN(w, 2 * w, 3, 2, d, device)                      # P2
        self.m2 = C2f(2 * w, 2 * w, c.n_rep(3), True, d, device)
        self.m3 = ConvBN(2 * w, 4 * w, 3, 2, d, device)                  # P3
        self.m4 = C2f(4 * w, 4 * w, c.n_rep(6), True, d, device)
        self.m5 = ConvBN(4 * w, 8 * w, 3, 2, d, device)                  # P4
        self.m6 = C2f(8 * w, 8 * w, c.n_rep(6), True, d, device)
        self.m7 = ConvBN(8 * w, c5, 3, 2, d, device)                     # P5
        self.m8 = C2f(c5, c5, c.n_rep(3), True, d, device)
        self.m9 = SPPF(c5, c5, d, device)
        self.m12 = C2f(c5 + 8 * w, 8 * w, c.n_rep(3), False, d, device)
        self.m15 = C2f(8 * w + 4 * w, 4 * w, c.n_rep(3), False, d, device)
        self.m16 = ConvBN(4 * w, 4 * w, 3, 2, d, device)
        self.m18 = C2f(4 * w + 8 * w, 8 * w, c.n_rep(3), False, d, device)
        self.m19 = ConvBN(8 * w, 8 * w, 3, 2, d, device)
        self.m21 = C2f(8 * w + c5, c5, c.n_rep(3), False, d, device)
        self.m22 = DetectHead(c, (4 * w, 8 * w, c5), device)

    def forward(self, images: torch.Tensor):
        c = self.cfg
        dev = self.m0.conv.weight.device
        x = images.to(dev, c.dtype).permute(0, 3, 1, 2)                  # NHWC -> NCHW
        x = self.m1(self.m0(x))
        x = self.m3(self.m2(x))
        p3 = self.m4(x)
        p4 = self.m6(self.m5(p3))
        p5 = self.m9(self.m8(self.m7(p4)))

        # PAN-FPN
        u = resize_nearest(p5, (*p5.shape[:2], *p4.shape[2:]))
        f4 = self.m12(torch.cat([u, p4], dim=1))
        u = resize_nearest(f4, (*f4.shape[:2], *p3.shape[2:]))
        f3 = self.m15(torch.cat([u, p3], dim=1))
        f4b = self.m18(torch.cat([self.m16(f3), f4], dim=1))
        f5 = self.m21(torch.cat([self.m19(f4b), p5], dim=1))
        box_out, cls_out = self.m22([f3, f4b, f5])

        boxes_all, scores_all = [], []
        bins = torch.arange(c.reg_max, dtype=torch.float32, device=dev)
        for b, q in zip(box_out, cls_out):
            B, _, gh, gw = b.shape
            stride = images.shape[1] // gh
            dist = b.permute(0, 2, 3, 1).reshape(B, gh, gw, 4, c.reg_max)
            dist = torch.sum(torch.softmax(dist, dim=-1) * bins, dim=-1)
            ys = torch.arange(gh, dtype=torch.float32, device=dev) + 0.5
            xs = torch.arange(gw, dtype=torch.float32, device=dev) + 0.5
            cy, cx = torch.meshgrid(ys, xs, indexing="ij")
            x0 = (cx - dist[..., 0]) * stride
            y0 = (cy - dist[..., 1]) * stride
            x1 = (cx + dist[..., 2]) * stride
            y1 = (cy + dist[..., 3]) * stride
            boxes_all.append(torch.stack([x0, y0, x1, y1], -1).reshape(B, -1, 4))
            scores_all.append(torch.sigmoid(q).permute(0, 2, 3, 1).reshape(B, -1, c.num_classes))
        return torch.cat(boxes_all, dim=1), torch.cat(scores_all, dim=1)


def detect_hands_yolov8(model: YoloV8, image_rgb: np.ndarray, conf: float = 0.3,
                        iou_thresh: float = 0.5, max_det: int = 10) -> List[dict]:
    """WiLoR contract: per hand a dict(box xyxy in image px, score, is_right),
    the most confident first. The resize is PIL's on the host; the forward,
    the confidence filter and NMS run on the model's device."""
    from PIL import Image

    from followmyhold_tpu_torch.ops.nms import nms

    c = model.cfg
    H, W = image_rgb.shape[:2]
    s = c.image_size
    img = np.asarray(Image.fromarray(image_rgb).resize((s, s)), np.float32) / 255.0
    with torch.no_grad():
        boxes, scores = model(torch.from_numpy(img)[None])
        score, cls = scores[0].max(dim=-1)
        keepable = score > conf
        b, sc, cl = boxes[0][keepable], score[keepable], cls[keepable]
        if b.shape[0] == 0:
            return []
        keep_mask = nms(b, sc, iou_threshold=iou_thresh)
    b, sc, cl, keep_mask = (t.cpu().numpy() for t in (b, sc, cl, keep_mask))
    order = np.argsort(-sc)
    out = []
    sx, sy = W / s, H / s
    for i in order:
        if not keep_mask[i] or len(out) >= max_det:
            continue
        x0, y0, x1, y1 = b[i]
        out.append(dict(box=np.array([x0 * sx, y0 * sy, x1 * sx, y1 * sy], np.float32),
                        score=float(sc[i]), is_right=bool(cl[i] == 1)))
    return out
