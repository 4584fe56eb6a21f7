"""MoGe-2 torch checkpoint -> the ``moge`` parameter file (the port's copy of
the reference's ``convert/moge.py``).

Maps the reference checkpoint layout (moge/model/v2.py state dict:
encoder.backbone.* = DINOv2, encoder.output_projections.*, neck.*,
points_head.*, normal_head.*, mask_head.*, scale_head.*) onto models/moge.MoGe.

    python -m followmyhold_tpu_torch.convert.moge --ckpt model.pt
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

from followmyhold_tpu_torch.convert.common import (
    ConversionReport,
    as_tensor,
    conv_kernel,
    dense_kernel,
    filled,
    load_checkpoint,
    put,
)
from followmyhold_tpu_torch.convert.vit_torch import convert_vit
from followmyhold_tpu_torch.models.moge import MoGe, MoGeConfig
from followmyhold_tpu_torch.utils.params import save_params, torch_to_flax


def conv_stack(sd: Dict[str, Any], params, torch_prefix: str,
               flax_root: str, n_levels: int, num_res_blocks: int,
               resampler: str, report: ConversionReport) -> None:
    """Map a reference ConvStack state dict (modules.py ConvStack) onto the
    models/moge.ConvStack param tree.

    Torch layout: input_blocks.{i} (1x1 conv or Identity),
    res_blocks.{i}.{j}.layers.{0:GN,2:conv3,3:GN,5:conv3} + optional
    skip_connection, resamplers.{i} (pixel_shuffle: Sequential[conv3,
    PixelShuffle, conv3] -> indices 0/2; bilinear/nearest:
    Sequential[Upsample, conv3] -> index 1), output_blocks.{i}."""

    def take(src, dst, tf=None):
        full = f"{torch_prefix}.{src}"
        if full in sd:
            put(params, f"{flax_root}/{dst}", tf(sd.pop(full)) if tf else sd.pop(full),
                report)
            return True
        return False

    for i in range(n_levels):
        take(f"input_blocks.{i}.weight", f"in{i}/kernel", conv_kernel)
        take(f"input_blocks.{i}.bias", f"in{i}/bias")
        for j in range(num_res_blocks):
            base = f"res_blocks.{i}.{j}"
            dst = f"res{i}_{j}"
            ok = take(f"{base}.layers.0.weight", f"{dst}/in_norm/scale")
            if not ok:
                report.missing_src.append(f"{torch_prefix}.{base}.layers.0.weight")
            take(f"{base}.layers.0.bias", f"{dst}/in_norm/bias")
            take(f"{base}.layers.2.weight", f"{dst}/conv1/conv/kernel", conv_kernel)
            take(f"{base}.layers.2.bias", f"{dst}/conv1/conv/bias")
            take(f"{base}.layers.3.weight", f"{dst}/hidden_norm/scale")
            take(f"{base}.layers.3.bias", f"{dst}/hidden_norm/bias")
            take(f"{base}.layers.5.weight", f"{dst}/conv2/conv/kernel", conv_kernel)
            take(f"{base}.layers.5.bias", f"{dst}/conv2/conv/bias")
            take(f"{base}.skip_connection.weight", f"{dst}/skip/kernel", conv_kernel)
            take(f"{base}.skip_connection.bias", f"{dst}/skip/bias")
        if i < n_levels - 1:
            if resampler == "pixel_shuffle":
                take(f"resamplers.{i}.0.weight", f"up{i}/conv0/conv/kernel",
                     conv_kernel)
                take(f"resamplers.{i}.0.bias", f"up{i}/conv0/conv/bias")
                take(f"resamplers.{i}.2.weight", f"up{i}/conv1/conv/kernel",
                     conv_kernel)
                take(f"resamplers.{i}.2.bias", f"up{i}/conv1/conv/bias")
            else:  # bilinear / nearest: Upsample at 0, conv at 1
                take(f"resamplers.{i}.1.weight", f"up{i}/conv0/conv/kernel",
                     conv_kernel)
                take(f"resamplers.{i}.1.bias", f"up{i}/conv0/conv/bias")
        take(f"output_blocks.{i}.weight", f"out{i}/kernel", conv_kernel)
        take(f"output_blocks.{i}.bias", f"out{i}/bias")


def detect_conv_stack_resampler(sd: Dict[str, Any],
                                torch_prefix: str = "neck") -> str:
    """Infer the Resampler type from state-dict key indices."""
    if f"{torch_prefix}.resamplers.0.2.weight" in sd:
        return "pixel_shuffle"
    if f"{torch_prefix}.resamplers.0.1.weight" in sd:
        return "bilinear"   # or nearest — conv layout identical
    return "pixel_shuffle"


def convert_moge(torch_sd: Dict[str, Any], cfg: MoGeConfig | None = None):
    cfg = cfg or MoGeConfig()
    model = MoGe(cfg, device="meta")
    params = torch_to_flax(model)
    report = ConversionReport()
    sd = {k: as_tensor(v) for k, v in torch_sd.items()}

    # DINOv2 backbone
    convert_vit(sd, params, prefix="encoder.backbone.",
                flax_prefix="params/backbone", depth=cfg.encoder.depth,
                report=report)
    sd = {k: v for k, v in sd.items() if not k.startswith("encoder.backbone.")}

    def take(src, dst, tf=None):
        if src in sd:
            put(params, dst, tf(sd.pop(src)) if tf else sd.pop(src), report)
        else:
            report.missing_src.append(src)

    for i in range(len(cfg.intermediate_layers)):
        take(f"encoder.output_projections.{i}.weight",
             f"params/proj{i}/kernel", conv_kernel)
        take(f"encoder.output_projections.{i}.bias", f"params/proj{i}/bias")

    conv_stack(sd, params, "neck", "params/neck", len(cfg.neck_dims),
               cfg.num_res_blocks, cfg.resampler, report)
    for head in ("points_head", "mask_head", "normal_head"):
        if head == "normal_head" and not cfg.use_normal_head:
            continue
        conv_stack(sd, params, head, f"params/{head}", len(cfg.head_dims),
                   cfg.num_res_blocks, cfg.resampler, report)

    # scale head MLP
    n_scale = len(cfg.scale_head_dims)
    for i in range(n_scale - 1):
        take(f"scale_head.{2 * i}.weight", f"params/scale{i}/kernel", dense_kernel)
        take(f"scale_head.{2 * i}.bias", f"params/scale{i}/bias")
    take(f"scale_head.{2 * (n_scale - 1)}.weight", "params/scale_out/kernel",
         dense_kernel)
    take(f"scale_head.{2 * (n_scale - 1)}.bias", "params/scale_out/bias")

    report.unused_src.extend(
        k for k in sd if not k.startswith("encoder.backbone."))
    return filled(params, model), report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True)
    args = parser.parse_args(argv)
    ckpt = load_checkpoint(args.ckpt)
    params, report = convert_moge(ckpt["model"])
    print(report.summary())
    print("saved ->", save_params("moge", params))
    if report.missing_src or report.unused_src:
        print("inspect naming drift:",
              report.missing_src[:10], report.unused_src[:10])


if __name__ == "__main__":
    main()
