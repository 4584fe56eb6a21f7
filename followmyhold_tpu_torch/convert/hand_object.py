"""hand_object_detector checkpoint -> the ``hand_object_detector`` parameter
file (the port's copy of the reference's ``convert/hand_object.py``).

Maps the reference Faster R-CNN state dict (third_party/estimator/
hand_object_detector: RCNN_base.* = caffe-style ResNet-101 conv1..layer3,
RCNN_top.0 = layer4, RCNN_rpn.*, RCNN_cls_score / RCNN_bbox_pred,
extension_layer.*) onto models/hand_object_detector.HandObjectDetector.
Frozen BatchNorms fuse into conv biases (``yolov8.fuse_conv_bn``). The
checkpoint pickles training state beside the weights, so it loads with
``weights_only=False`` as the reference loads it.

    python -m followmyhold_tpu_torch.convert.hand_object --ckpt faster_rcnn_1_8_132028.pth
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

from followmyhold_tpu_torch.convert.common import (
    ConversionReport,
    as_tensor,
    conv_kernel,
    dense_kernel,
    filled,
    load_checkpoint,
    put,
)
from followmyhold_tpu_torch.convert.yolov8 import fuse_conv_bn
from followmyhold_tpu_torch.models.hand_object_detector import FrcnnConfig, HandObjectDetector
from followmyhold_tpu_torch.utils.params import save_params, torch_to_flax


def convert_hand_object(torch_sd: Dict[str, Any], cfg: FrcnnConfig | None = None,
                        init_size: int = 128):
    cfg = cfg or FrcnnConfig()
    model = HandObjectDetector(cfg, device="meta")
    params = torch_to_flax(model)
    report = ConversionReport()
    sd = {k: as_tensor(v) for k, v in torch_sd.items()
          if not k.endswith("num_batches_tracked")}

    def take(src, dst, tf=None):
        if src in sd:
            put(params, f"params/{dst}", tf(sd.pop(src)) if tf else sd.pop(src),
                report)
        else:
            report.missing_src.append(src)

    def fused(conv_src, bn_src, dst):
        if f"{conv_src}.weight" not in sd:
            report.missing_src.append(f"{conv_src}.weight")
            return
        wf, bf = fuse_conv_bn(
            sd.pop(f"{conv_src}.weight"), sd.pop(f"{bn_src}.weight"),
            sd.pop(f"{bn_src}.bias"), sd.pop(f"{bn_src}.running_mean"),
            sd.pop(f"{bn_src}.running_var"), eps=1e-5)
        put(params, f"params/{dst}/conv/kernel", conv_kernel(wf), report)
        put(params, f"params/{dst}/conv/bias", bf, report)

    def dense(src, dst):
        take(f"{src}.weight", f"{dst}/kernel", dense_kernel)
        take(f"{src}.bias", f"{dst}/bias")

    # stem (RCNN_base.0 = conv1, .1 = bn1)
    fused("RCNN_base.0", "RCNN_base.1", "conv1")

    # layers 1-3 live at RCNN_base.4/5/6; layer4 at RCNN_top.0
    layer_srcs = {"layer1": "RCNN_base.4", "layer2": "RCNN_base.5",
                  "layer3": "RCNN_base.6", "layer4": "RCNN_top.0"}
    for k, blocks in zip(("layer1", "layer2", "layer3", "layer4"),
                         cfg.stage_blocks):
        src = layer_srcs[k]
        for b in range(blocks):
            for ci in (1, 2, 3):
                fused(f"{src}.{b}.conv{ci}", f"{src}.{b}.bn{ci}",
                      f"{k}/block{b}/conv{ci}")
            if f"{src}.{b}.downsample.0.weight" in sd:
                fused(f"{src}.{b}.downsample.0", f"{src}.{b}.downsample.1",
                      f"{k}/block{b}/downsample")

    # RPN
    take("RCNN_rpn.RPN_Conv.weight", "rpn_conv/kernel", conv_kernel)
    take("RCNN_rpn.RPN_Conv.bias", "rpn_conv/bias")
    take("RCNN_rpn.RPN_cls_score.weight", "rpn_cls/kernel", conv_kernel)
    take("RCNN_rpn.RPN_cls_score.bias", "rpn_cls/bias")
    take("RCNN_rpn.RPN_bbox_pred.weight", "rpn_box/kernel", conv_kernel)
    take("RCNN_rpn.RPN_bbox_pred.bias", "rpn_box/bias")

    # heads
    dense("RCNN_cls_score", "cls_score")
    dense("RCNN_bbox_pred", "bbox_pred")
    dense("extension_layer.hand_contact_state_layer.0", "ext_contact1")
    dense("extension_layer.hand_contact_state_layer.3", "ext_contact2")
    dense("extension_layer.hand_dydx_layer", "ext_dydx")
    dense("extension_layer.hand_lr_layer", "ext_lr")

    report.unused_src.extend(sd.keys())
    return filled(params, model), report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True)
    args = parser.parse_args(argv)
    ckpt = load_checkpoint(args.ckpt, weights_only=False)
    sd = ckpt.get("model", ckpt)
    sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    params, report = convert_hand_object(sd)
    print(report.summary())
    print("saved ->", save_params("hand_object_detector", params))
    if report.missing_src or report.unused_src:
        print("naming drift:", report.missing_src[:8], report.unused_src[:8])


if __name__ == "__main__":
    main()
