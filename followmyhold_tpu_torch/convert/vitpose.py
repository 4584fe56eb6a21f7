"""ViTPose(+-H wholebody) torch checkpoint -> the ``vitpose`` parameter file
(the port's copy of the reference's ``convert/vitpose.py``).

The reference wraps the official ViTPose repo via mmpose. Its ViT backbone
uses timm naming (backbone.blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,
mlp.fc2}, backbone.last_norm) — handled by convert_vit — and the classic
top-down head: keypoint_head.deconv_layers.{0,3} ConvTranspose2d with
BatchNorms at {1,4}, then keypoint_head.final_layer. Inference-mode
BatchNorm is a per-channel affine, folded here into the model's
bn{i}_scale/bias params.

    python -m followmyhold_tpu_torch.convert.vitpose --ckpt vitpose_huge_wholebody.pth
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

from followmyhold_tpu_torch.convert.common import (
    ConversionReport,
    as_tensor,
    conv_kernel,
    filled,
    load_checkpoint,
    put,
)
from followmyhold_tpu_torch.convert.vit_torch import convert_vit
from followmyhold_tpu_torch.models.vitpose import ViTPose, ViTPoseConfig
from followmyhold_tpu_torch.utils.params import save_params, torch_to_flax


def _deconv_kernel(w) -> torch.Tensor:
    """torch ConvTranspose2d [in, out, kh, kw] -> flax [kh, kw, in, out],
    spatially flipped (flax ConvTranspose correlates; torch's transposed
    conv convolves)."""
    return as_tensor(w).permute(2, 3, 0, 1).flip(0, 1)


def convert_vitpose(torch_sd: Dict[str, Any],
                    cfg: ViTPoseConfig | None = None, eps: float = 1e-5):
    cfg = cfg or ViTPoseConfig()
    model = ViTPose(cfg, device="meta")
    params = torch_to_flax(model)
    report = ConversionReport()
    sd = {k: as_tensor(v) for k, v in torch_sd.items()}

    # convert_vit sees only backbone.* (it prefix-filters a copy) and reports
    # leftover backbone keys as unused itself
    convert_vit(sd, params, prefix="backbone.", flax_prefix="params/backbone",
                depth=cfg.backbone.depth, report=report)
    head = {k: v for k, v in sd.items() if k.startswith("keypoint_head.")}
    report.unused_src.extend(
        k for k in sd if not k.startswith(("backbone.", "keypoint_head.")))

    def take(src, dst, tf=None):
        if src in head:
            put(params, f"params/{dst}", tf(head.pop(src)) if tf else head.pop(src),
                report)
        else:
            report.missing_src.append(src)

    for i in range(cfg.num_deconv):
        dl = 3 * i           # ConvTranspose at indices 0, 3; BN at 1, 4
        take(f"keypoint_head.deconv_layers.{dl}.weight",
             f"deconv{i}/kernel", _deconv_kernel)
        bn = f"keypoint_head.deconv_layers.{dl + 1}"
        if all(f"{bn}.{p}" in head for p in
               ("weight", "bias", "running_mean", "running_var")):
            gamma = head.pop(f"{bn}.weight")
            beta = head.pop(f"{bn}.bias")
            mean = head.pop(f"{bn}.running_mean")
            var = head.pop(f"{bn}.running_var")
            head.pop(f"{bn}.num_batches_tracked", None)
            scale = gamma / torch.sqrt(var + eps)
            put(params, f"params/bn{i}_scale", scale, report)
            put(params, f"params/bn{i}_bias", beta - mean * scale, report)
        else:
            report.missing_src.append(f"{bn}.*")
    take("keypoint_head.final_layer.weight", "final/kernel", conv_kernel)
    take("keypoint_head.final_layer.bias", "final/bias")

    report.unused_src.extend(head.keys())
    return filled(params, model), report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True)
    args = parser.parse_args(argv)
    ckpt = load_checkpoint(args.ckpt)
    sd = ckpt.get("state_dict", ckpt)
    params, report = convert_vitpose(
        {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)})
    print(report.summary())
    print("saved ->", save_params("vitpose", params))
    if report.missing_src or report.unused_src:
        print("naming drift:", report.missing_src[:8], report.unused_src[:8])


if __name__ == "__main__":
    main()
