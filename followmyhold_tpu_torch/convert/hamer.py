"""HaMeR torch checkpoint -> the ``hamer`` parameter file (the port's copy of
the reference's ``convert/hamer.py``).

Maps the reference checkpoint layout (hamer/models/hamer.py state dict:
backbone.* = ViTPose ViT-H, mano_head.* = MANOTransformerDecoderHead) onto
models/hamer.Hamer. The checkpoint is Lightning's, whose ``state_dict`` sits
beside pickled training state, so it loads with ``weights_only=False`` as the
reference loads it: convert only a checkpoint you trust. Run:

    python -m followmyhold_tpu_torch.convert.hamer --ckpt /path/hamer.ckpt
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

from followmyhold_tpu_torch.convert.common import (
    ConversionReport,
    as_tensor,
    dense_kernel,
    filled,
    load_checkpoint,
    put,
)
from followmyhold_tpu_torch.convert.vit_torch import convert_vit
from followmyhold_tpu_torch.models.hamer import Hamer, HamerConfig
from followmyhold_tpu_torch.utils.params import save_params, torch_to_flax


def convert_hamer(torch_sd: Dict[str, Any], cfg: HamerConfig | None = None):
    cfg = cfg or HamerConfig()
    model = Hamer(cfg, device="meta")
    params = torch_to_flax(model)
    report = ConversionReport()

    # backbone (torch keys "backbone.*")
    convert_vit(torch_sd, params, prefix="backbone.",
                flax_prefix="params/backbone/vit",
                depth=cfg.backbone.depth, report=report)
    convert_mano_head(torch_sd, params, cfg, report=report)
    return filled(params, model), report


def convert_mano_head(torch_sd: Dict[str, Any], params, cfg: HamerConfig,
                      flax_prefix: str = "params/mano_head",
                      prefix: str = "mano_head.",
                      report: ConversionReport | None = None):
    """MANOTransformerDecoderHead state dict -> ManoHead params (in place).
    ``decpose`` keeps the checkpoint's 6d-rotation ordering: its rows go
    over as they are, as the head reads them."""
    report = report or ConversionReport()
    sd = {k: as_tensor(v) for k, v in torch_sd.items() if k.startswith(prefix)}

    def grab(key):
        full = prefix + key
        if full in sd:
            return sd.pop(full)
        report.missing_src.append(full)
        return None

    head = flax_prefix
    for src, dst, tf in (
        ("decpose.weight", f"{head}/decpose/kernel", dense_kernel),
        ("decpose.bias", f"{head}/decpose/bias", None),
        ("decshape.weight", f"{head}/decshape/kernel", dense_kernel),
        ("decshape.bias", f"{head}/decshape/bias", None),
        ("deccam.weight", f"{head}/deccam/kernel", dense_kernel),
        ("deccam.bias", f"{head}/deccam/bias", None),
        ("init_hand_pose", f"{head}/init_hand_pose", None),
        ("init_betas", f"{head}/init_betas", None),
        ("init_cam", f"{head}/init_cam", None),
        ("transformer.to_token_embedding.weight",
         f"{head}/input_proj/kernel", dense_kernel),
        ("transformer.to_token_embedding.bias",
         f"{head}/input_proj/bias", None),
        ("transformer.pos_embedding", f"{head}/pos_embedding", None),
    ):
        v = grab(src)
        if v is not None:
            put(params, dst, tf(v) if tf else v, report)

    # transformer decoder layers: torch pose_transformer layout is
    # transformer.layers.{i}.{0,1,2}.{norm,fn}.* (self-attn, cross-attn, ff);
    # the Flax tree folds depth with nn.scan -> stack along a leading axis.
    layer_map = [
        ("0.norm.weight", "norm_sa/scale", None),
        ("0.norm.bias", "norm_sa/bias", None),
        ("0.fn.to_qkv.weight", "sa/to_qkv/kernel", dense_kernel),
        ("0.fn.to_out.0.weight", "sa/to_out/kernel", dense_kernel),
        ("0.fn.to_out.0.bias", "sa/to_out/bias", None),
        ("1.norm.weight", "norm_ca/scale", None),
        ("1.norm.bias", "norm_ca/bias", None),
        ("1.fn.to_q.weight", "ca/to_q/kernel", dense_kernel),
        ("1.fn.to_kv.weight", "ca/to_kv/kernel", dense_kernel),
        ("1.fn.to_out.0.weight", "ca/to_out/kernel", dense_kernel),
        ("1.fn.to_out.0.bias", "ca/to_out/bias", None),
        ("2.norm.weight", "norm_ff/scale", None),
        ("2.norm.bias", "norm_ff/bias", None),
        ("2.fn.net.0.weight", "ff1/kernel", dense_kernel),
        ("2.fn.net.0.bias", "ff1/bias", None),
        ("2.fn.net.3.weight", "ff2/kernel", dense_kernel),
        ("2.fn.net.3.bias", "ff2/bias", None),
    ]
    for src_rel, dst_rel, tf in layer_map:
        stacked = []
        ok = True
        for i in range(cfg.head_depth):
            # TransformerDecoder wraps TransformerCrossAttn as .transformer,
            # so layer keys are mano_head.transformer.transformer.layers.*
            key = f"{prefix}transformer.transformer.layers.{i}.{src_rel}"
            if key in sd:
                v = sd.pop(key)
                stacked.append(tf(v) if tf else v)
            else:
                report.missing_src.append(key)
                ok = False
        if ok and stacked:
            put(params, f"{head}/layers/layer/{dst_rel}", torch.stack(stacked),
                report)

    report.unused_src.extend(k for k in sd)
    return params, report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True)
    args = parser.parse_args(argv)

    ckpt = load_checkpoint(args.ckpt, weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    params, report = convert_hamer(sd)
    print(report.summary())
    path = save_params("hamer", params)
    print(f"saved -> {path}")


if __name__ == "__main__":
    main()
