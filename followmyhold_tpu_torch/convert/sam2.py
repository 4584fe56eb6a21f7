"""SAM-2.1 checkpoint -> the ``sam2`` parameter file (the port's copy of the
reference's ``convert/sam2.py``).

Maps the facebookresearch/sam2 state dict (sam2.1_hiera_large.pt["model"]:
image_encoder.trunk/neck, sam_prompt_encoder, sam_mask_decoder) onto
models/sam2.Sam2. The video memory modules (memory_attention, memory_encoder,
obj_ptr / maskmem tensors) are intentionally skipped — the pipeline only uses
SAM2ImagePredictor.predict (LSAM/lang_sam/models/sam.py:82-86).

The two upscaling ConvTranspose kernels are flipped in space, as ViTPose's
are: the file holds Flax's layout, whose transposed convolution applies its
kernel flipped, so the converted mask upscaling computes what torch's
``conv_transpose2d`` computes with the checkpoint's weight. (The JAX
package's SAM2 converter leaves them unflipped, which mirrors the upscaling.)

    python -m followmyhold_tpu_torch.convert.sam2 --ckpt sam2.1_hiera_large.pt
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np
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
from followmyhold_tpu_torch.models.sam2 import SAM2_LARGE, Sam2, Sam2Config
from followmyhold_tpu_torch.utils.params import save_params, torch_to_flax

_SKIP_PREFIXES = (
    "memory_attention.", "memory_encoder.", "mask_downsample.",
    "obj_ptr_proj.", "obj_ptr_tpos_proj.", "sam_prompt_encoder.mask_downscaling.",
    "sam_mask_decoder.pred_obj_score_head.",
)
_SKIP_EXACT = ("maskmem_tpos_enc", "no_mem_pos_enc",
               "no_obj_ptr", "maskmem_feature_norm")


def convt_kernel(w) -> torch.Tensor:
    """torch ConvTranspose2d [in, out, kh, kw] -> flax [kh, kw, in, out],
    spatially flipped (flax ConvTranspose correlates; torch's transposed
    conv convolves)."""
    return as_tensor(w).permute(2, 3, 0, 1).flip(0, 1)


def convert_sam2(torch_sd: Dict[str, Any], cfg: Sam2Config | None = None):
    cfg = cfg or SAM2_LARGE
    model = Sam2(cfg, device="meta")
    params = torch_to_flax(model)
    report = ConversionReport()
    sd = {k: as_tensor(v) for k, v in torch_sd.items()
          if not (k.startswith(_SKIP_PREFIXES) or k in _SKIP_EXACT)}

    def take(src, dst, tf=None):
        if src in sd:
            put(params, f"params/{dst}", tf(sd.pop(src)) if tf else sd.pop(src),
                report)
        else:
            report.missing_src.append(src)

    def dense(src, dst):
        take(f"{src}.weight", f"{dst}/kernel", dense_kernel)
        take(f"{src}.bias", f"{dst}/bias")

    def ln(src, dst):
        take(f"{src}.weight", f"{dst}/scale")
        take(f"{src}.bias", f"{dst}/bias")

    # directly_add_no_mem_embed: learned [1,1,d] added to the stride-16
    # embedding on the image-predictor path
    take("no_mem_embed", "no_mem_embed")

    # ---- Hiera trunk ----
    tr = "image_encoder.trunk"
    take(f"{tr}.patch_embed.proj.weight", "trunk/patch_embed/kernel", conv_kernel)
    take(f"{tr}.patch_embed.proj.bias", "trunk/patch_embed/bias")
    take(f"{tr}.pos_embed", "trunk/pos_embed", lambda w: w.permute(0, 2, 3, 1))
    take(f"{tr}.pos_embed_window", "trunk/pos_embed_window",
         lambda w: w.permute(0, 2, 3, 1))
    total = int(np.sum(cfg.stages))
    q_pool_blocks = set(np.cumsum(cfg.stages)[:-1].tolist())
    for i in range(total):
        src = f"{tr}.blocks.{i}"
        dst = f"trunk/block{i}"
        ln(f"{src}.norm1", f"{dst}/norm1")
        ln(f"{src}.norm2", f"{dst}/norm2")
        dense(f"{src}.attn.qkv", f"{dst}/attn/qkv")
        dense(f"{src}.attn.proj", f"{dst}/attn/proj")
        dense(f"{src}.mlp.layers.0", f"{dst}/mlp1")
        dense(f"{src}.mlp.layers.1", f"{dst}/mlp2")
        if i in q_pool_blocks:
            dense(f"{src}.proj", f"{dst}/proj")

    # ---- FPN neck ----
    n = len(cfg.backbone_channel_list)
    for i in range(n):
        take(f"image_encoder.neck.convs.{i}.conv.weight",
             f"neck/conv{i}/kernel", conv_kernel)
        take(f"image_encoder.neck.convs.{i}.conv.bias", f"neck/conv{i}/bias")

    # ---- prompt encoder ----
    pe = "sam_prompt_encoder"
    take(f"{pe}.pe_layer.positional_encoding_gaussian_matrix",
         "prompt/pe_gaussian")
    for i in range(4):
        take(f"{pe}.point_embeddings.{i}.weight", f"prompt/point_embed_{i}",
             lambda w: w[0])
    take(f"{pe}.not_a_point_embed.weight", "prompt/not_a_point_embed",
         lambda w: w[0])
    take(f"{pe}.no_mask_embed.weight", "prompt/no_mask_embed", lambda w: w[0])

    # ---- mask decoder ----
    md = "sam_mask_decoder"
    take(f"{md}.iou_token.weight", "decoder/iou_token")
    take(f"{md}.mask_tokens.weight", "decoder/mask_tokens")
    take(f"{md}.obj_score_token.weight", "decoder/obj_score_token")
    for i in range(cfg.decoder_depth):
        src = f"{md}.transformer.layers.{i}"
        dst = f"decoder/block{i}"
        for attn in ("self_attn", "cross_attn_token_to_image",
                     "cross_attn_image_to_token"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                dense(f"{src}.{attn}.{proj}", f"{dst}/{attn}/{proj}")
        for k in range(1, 5):
            ln(f"{src}.norm{k}", f"{dst}/norm{k}")
        # TwoWayAttentionBlock uses SAM's MLPBlock (lin1/lin2), unlike the
        # hypernetwork/iou MLPs which use layers.{i}
        dense(f"{src}.mlp.lin1", f"{dst}/mlp1")
        dense(f"{src}.mlp.lin2", f"{dst}/mlp2")
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        dense(f"{md}.transformer.final_attn_token_to_image.{proj}",
              f"decoder/final_attn_token_to_image/{proj}")
    ln(f"{md}.transformer.norm_final_attn", "decoder/norm_final_attn")

    take(f"{md}.output_upscaling.0.weight", "decoder/upscale1/kernel",
         convt_kernel)
    take(f"{md}.output_upscaling.0.bias", "decoder/upscale1/bias")
    ln(f"{md}.output_upscaling.1", "decoder/upscale_norm")
    take(f"{md}.output_upscaling.3.weight", "decoder/upscale2/kernel",
         convt_kernel)
    take(f"{md}.output_upscaling.3.bias", "decoder/upscale2/bias")
    take(f"{md}.conv_s0.weight", "decoder/conv_s0/kernel", conv_kernel)
    take(f"{md}.conv_s0.bias", "decoder/conv_s0/bias")
    take(f"{md}.conv_s1.weight", "decoder/conv_s1/kernel", conv_kernel)
    take(f"{md}.conv_s1.bias", "decoder/conv_s1/bias")
    for t in range(cfg.num_mask_tokens):
        for li in range(3):
            dense(f"{md}.output_hypernetworks_mlps.{t}.layers.{li}",
                  f"decoder/hyper{t}_l{li}")
    for li in range(3):
        dense(f"{md}.iou_prediction_head.layers.{li}", f"decoder/iou_l{li}")

    report.unused_src.extend(sd.keys())
    return filled(params, model), report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True)
    args = parser.parse_args(argv)
    ckpt = load_checkpoint(args.ckpt)
    params, report = convert_sam2(ckpt["model"])
    print(report.summary())
    print("saved ->", save_params("sam2", params))
    if report.missing_src or report.unused_src:
        print("naming drift:", report.missing_src[:8], report.unused_src[:8])


if __name__ == "__main__":
    main()
