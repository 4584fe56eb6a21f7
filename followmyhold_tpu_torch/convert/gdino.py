"""GroundingDINO HF checkpoint -> the ``gdino`` parameter file and its BERT
vocabulary (the port's copy of the reference's ``convert/gdino.py``).

Maps the `GroundingDinoForObjectDetection` state dict
(IDEA-Research/grounding-dino-base layout: model.backbone.conv_encoder.model.*
= SwinBackbone, model.text_backbone.* = BertModel, model.encoder/decoder.*,
bbox_embed.*) onto models/gdino.GroundingDino. Run:

    python -m followmyhold_tpu_torch.convert.gdino --ckpt pytorch_model.bin
"""

from __future__ import annotations

import argparse
import os
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
from followmyhold_tpu_torch.models.gdino import GDINO_BASE, GroundingDino, GroundingDinoConfig
from followmyhold_tpu_torch.text.tokenizers import install_tokenizer_files
from followmyhold_tpu_torch.utils.params import save_params, torch_to_flax


def _mha(take, src, dst):
    """GroundingDinoMultiheadAttention / Bert self-attention q,k,v,out."""
    for name in ("query", "key", "value"):
        take(f"{src}.{name}.weight", f"{dst}/{name}/kernel", dense_kernel)
        take(f"{src}.{name}.bias", f"{dst}/{name}/bias")


def _deformable(take, src, dst):
    for name in ("sampling_offsets", "attention_weights", "value_proj",
                 "output_proj"):
        take(f"{src}.{name}.weight", f"{dst}/{name}/kernel", dense_kernel)
        take(f"{src}.{name}.bias", f"{dst}/{name}/bias")


def _ln(take, src, dst):
    take(f"{src}.weight", f"{dst}/scale")
    take(f"{src}.bias", f"{dst}/bias")


def _dense(take, src, dst):
    take(f"{src}.weight", f"{dst}/kernel", dense_kernel)
    take(f"{src}.bias", f"{dst}/bias")


def _mlp_head(take, src, dst, n_layers=3):
    for i in range(n_layers):
        _dense(take, f"{src}.layers.{i}", f"{dst}/layer{i}")


def convert_gdino(torch_sd: Dict[str, Any], cfg: GroundingDinoConfig | None = None):
    cfg = cfg or GDINO_BASE
    model = GroundingDino(cfg, device="meta")
    params = torch_to_flax(model)
    report = ConversionReport()
    sd = {k: as_tensor(v) for k, v in torch_sd.items()}

    def take(src, dst, tf=None):
        if src in sd:
            put(params, f"params/{dst}", tf(sd.pop(src)) if tf else sd.pop(src),
                report)
        else:
            report.missing_src.append(src)

    # ---- Swin backbone ----
    bb = "model.backbone.conv_encoder.model"
    take(f"{bb}.embeddings.patch_embeddings.projection.weight",
         "backbone/patch_embed/kernel", conv_kernel)
    take(f"{bb}.embeddings.patch_embeddings.projection.bias",
         "backbone/patch_embed/bias")
    _ln(take, f"{bb}.embeddings.norm", "backbone/embed_norm")
    for s, depth in enumerate(cfg.swin.depths):
        for b in range(depth):
            src = f"{bb}.encoder.layers.{s}.blocks.{b}"
            dst = f"backbone/stage{s}_block{b}"
            _ln(take, f"{src}.layernorm_before", f"{dst}/layernorm_before")
            _ln(take, f"{src}.layernorm_after", f"{dst}/layernorm_after")
            take(f"{src}.attention.self.relative_position_bias_table",
                 f"{dst}/attn/relative_position_bias_table")
            sd.pop(f"{src}.attention.self.relative_position_index", None)
            _mha(take, f"{src}.attention.self", f"{dst}/attn")
            _dense(take, f"{src}.attention.output.dense", f"{dst}/attn/proj")
            _dense(take, f"{src}.intermediate.dense", f"{dst}/intermediate")
            _dense(take, f"{src}.output.dense", f"{dst}/output")
        if s < len(cfg.swin.depths) - 1:
            take(f"{bb}.encoder.layers.{s}.downsample.reduction.weight",
                 f"backbone/downsample{s}/reduction/kernel", dense_kernel)
            _ln(take, f"{bb}.encoder.layers.{s}.downsample.norm",
                f"backbone/downsample{s}/norm")
    for stage in cfg.swin.out_stages:
        _ln(take, f"{bb}.hidden_states_norms.stage{stage}",
            f"backbone/out_norm{stage}")

    # ---- input projections ----
    for lvl in range(cfg.num_feature_levels):
        take(f"model.input_proj_vision.{lvl}.0.weight",
             f"input_proj_{lvl}/kernel", conv_kernel)
        take(f"model.input_proj_vision.{lvl}.0.bias", f"input_proj_{lvl}/bias")
        _ln(take, f"model.input_proj_vision.{lvl}.1", f"input_proj_norm_{lvl}")

    # ---- BERT text tower ----
    tb = "model.text_backbone"
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        take(f"{tb}.embeddings.{name}.weight",
             f"text_backbone/{name}/embedding")
    _ln(take, f"{tb}.embeddings.LayerNorm", "text_backbone/embed_norm")
    sd.pop(f"{tb}.embeddings.position_ids", None)
    for i in range(cfg.bert.num_hidden_layers):
        src = f"{tb}.encoder.layer.{i}"
        dst = f"text_backbone/layer{i}"
        _mha(take, f"{src}.attention.self", f"{dst}/self")
        _dense(take, f"{src}.attention.output.dense", f"{dst}/attn_out")
        _ln(take, f"{src}.attention.output.LayerNorm", f"{dst}/attn_norm")
        _dense(take, f"{src}.intermediate.dense", f"{dst}/intermediate")
        _dense(take, f"{src}.output.dense", f"{dst}/output")
        _ln(take, f"{src}.output.LayerNorm", f"{dst}/out_norm")
    _dense(take, "model.text_projection", "text_projection")

    # ---- globals ----
    take("model.level_embed", "level_embed")
    take("model.query_position_embeddings.weight", "query_position_embeddings")
    _dense(take, "model.enc_output", "enc_output")
    _ln(take, "model.enc_output_norm", "enc_output_norm")
    _mlp_head(take, "model.encoder_output_bbox_embed",
              "encoder_output_bbox_embed")
    _ln(take, "model.decoder.layer_norm", "decoder_layer_norm")
    _mlp_head(take, "model.decoder.reference_points_head",
              "reference_points_head", 2)
    _mlp_head(take, "bbox_embed.0", "decoder_bbox_embed")
    # tied clones of the shared bbox head
    for i in range(1, cfg.decoder_layers):
        for j in range(3):
            sd.pop(f"bbox_embed.{i}.layers.{j}.weight", None)
            sd.pop(f"bbox_embed.{i}.layers.{j}.bias", None)
    for i in range(cfg.decoder_layers):
        for j in range(3):
            sd.pop(f"model.decoder.bbox_embed.{i}.layers.{j}.weight", None)
            sd.pop(f"model.decoder.bbox_embed.{i}.layers.{j}.bias", None)

    # ---- encoder layers ----
    for i in range(cfg.encoder_layers):
        src = f"model.encoder.layers.{i}"
        dst = f"encoder_layer{i}"
        f = f"{src}.fusion_layer"
        _ln(take, f"{f}.layer_norm_vision", f"{dst}/fusion_layer/layer_norm_vision")
        _ln(take, f"{f}.layer_norm_text", f"{dst}/fusion_layer/layer_norm_text")
        for name in ("vision_proj", "text_proj", "values_vision_proj",
                     "values_text_proj", "out_vision_proj", "out_text_proj"):
            _dense(take, f"{f}.attn.{name}", f"{dst}/fusion_layer/attn/{name}")
        take(f"{f}.vision_param", f"{dst}/fusion_layer/vision_param")
        take(f"{f}.text_param", f"{dst}/fusion_layer/text_param")

        t = f"{src}.text_enhancer_layer"
        _mha(take, f"{t}.self_attn", f"{dst}/text_enhancer_layer/self_attn")
        _dense(take, f"{t}.self_attn.out_proj",
               f"{dst}/text_enhancer_layer/self_attn/out_proj")
        _dense(take, f"{t}.fc1", f"{dst}/text_enhancer_layer/fc1")
        _dense(take, f"{t}.fc2", f"{dst}/text_enhancer_layer/fc2")
        _ln(take, f"{t}.layer_norm_before",
            f"{dst}/text_enhancer_layer/layer_norm_before")
        _ln(take, f"{t}.layer_norm_after",
            f"{dst}/text_enhancer_layer/layer_norm_after")

        d = f"{src}.deformable_layer"
        _deformable(take, f"{d}.self_attn", f"{dst}/deformable_layer/self_attn")
        _ln(take, f"{d}.self_attn_layer_norm",
            f"{dst}/deformable_layer/self_attn_layer_norm")
        _dense(take, f"{d}.fc1", f"{dst}/deformable_layer/fc1")
        _dense(take, f"{d}.fc2", f"{dst}/deformable_layer/fc2")
        _ln(take, f"{d}.final_layer_norm",
            f"{dst}/deformable_layer/final_layer_norm")

    # ---- decoder layers ----
    for i in range(cfg.decoder_layers):
        src = f"model.decoder.layers.{i}"
        dst = f"decoder_layer{i}"
        _mha(take, f"{src}.self_attn", f"{dst}/self_attn")
        _dense(take, f"{src}.self_attn.out_proj", f"{dst}/self_attn/out_proj")
        _ln(take, f"{src}.self_attn_layer_norm", f"{dst}/self_attn_layer_norm")
        _mha(take, f"{src}.encoder_attn_text", f"{dst}/encoder_attn_text")
        _dense(take, f"{src}.encoder_attn_text.out_proj",
               f"{dst}/encoder_attn_text/out_proj")
        _ln(take, f"{src}.encoder_attn_text_layer_norm",
            f"{dst}/encoder_attn_text_layer_norm")
        _deformable(take, f"{src}.encoder_attn", f"{dst}/encoder_attn")
        _ln(take, f"{src}.encoder_attn_layer_norm",
            f"{dst}/encoder_attn_layer_norm")
        _dense(take, f"{src}.fc1", f"{dst}/fc1")
        _dense(take, f"{src}.fc2", f"{dst}/fc2")
        _ln(take, f"{src}.final_layer_norm", f"{dst}/final_layer_norm")

    report.unused_src.extend(sd.keys())
    return filled(params, model), report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--vocab", default=None,
                        help="BERT vocab.txt (default: next to --ckpt); "
                             "installed to assets tokenizers/gdino/ so "
                             "detect_text_prompt can build real input_ids")
    args = parser.parse_args(argv)
    ckpt = load_checkpoint(args.ckpt)
    sd = {k: v for k, v in ckpt.items() if isinstance(v, torch.Tensor)}
    params, report = convert_gdino(sd)
    print(report.summary())
    print("saved ->", save_params("gdino", params))
    vocab = args.vocab or os.path.join(os.path.dirname(args.ckpt), "vocab.txt")
    if os.path.exists(vocab):
        print("tokenizer ->",
              install_tokenizer_files("gdino", {"vocab.txt": vocab}))
    else:
        print(f"WARNING: no vocab.txt at {vocab} — detect_text_prompt will "
              "refuse to run with these params until one is installed")
    if report.missing_src or report.unused_src:
        print("naming drift:", report.missing_src[:8], report.unused_src[:8])


if __name__ == "__main__":
    main()
