"""FLUX text towers: CLIP-L and T5 encoder checkpoints -> the ``flux_clip``
and ``flux_t5`` parameter files and their tokenizer files (the port's copy of
the reference's ``convert/flux_text.py``).

    python -m followmyhold_tpu_torch.convert.flux_text --clip_ckpt ... --t5_ckpt ...
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict

from followmyhold_tpu_torch.convert.common import (
    ConversionReport,
    as_tensor,
    dense_kernel,
    filled,
    load_checkpoint,
    put,
)
from followmyhold_tpu_torch.models.clip_text import CLIP_L, ClipTextConfig, ClipTextModel
from followmyhold_tpu_torch.models.t5 import T5_XXL, T5Config, T5Encoder
from followmyhold_tpu_torch.text.tokenizers import install_tokenizer_files
from followmyhold_tpu_torch.utils.params import save_params, torch_to_flax


def convert_clip_text(torch_sd: Dict[str, Any], cfg: ClipTextConfig | None = None):
    cfg = cfg or CLIP_L
    model = ClipTextModel(cfg, device="meta")
    params = torch_to_flax(model)
    report = ConversionReport()
    sd = {k: as_tensor(v) for k, v in torch_sd.items()
          if not k.endswith("position_ids")}

    def take(src, dst, tf=None):
        if src in sd:
            put(params, f"params/{dst}", tf(sd.pop(src)) if tf else sd.pop(src),
                report)
        else:
            report.missing_src.append(src)

    tm = "text_model"
    take(f"{tm}.embeddings.token_embedding.weight",
         "token_embedding/embedding")
    take(f"{tm}.embeddings.position_embedding.weight", "position_embedding")
    for i in range(cfg.num_layers):
        src = f"{tm}.encoder.layers.{i}"
        dst = f"layer{i}"
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            take(f"{src}.self_attn.{p}.weight", f"{dst}/{p}/kernel",
                 dense_kernel)
            take(f"{src}.self_attn.{p}.bias", f"{dst}/{p}/bias")
        for ln in ("layer_norm1", "layer_norm2"):
            take(f"{src}.{ln}.weight", f"{dst}/{ln}/scale")
            take(f"{src}.{ln}.bias", f"{dst}/{ln}/bias")
        take(f"{src}.mlp.fc1.weight", f"{dst}/fc1/kernel", dense_kernel)
        take(f"{src}.mlp.fc1.bias", f"{dst}/fc1/bias")
        take(f"{src}.mlp.fc2.weight", f"{dst}/fc2/kernel", dense_kernel)
        take(f"{src}.mlp.fc2.bias", f"{dst}/fc2/bias")
    take(f"{tm}.final_layer_norm.weight", "final_layer_norm/scale")
    take(f"{tm}.final_layer_norm.bias", "final_layer_norm/bias")

    report.unused_src.extend(sd.keys())
    return filled(params, model), report


def convert_t5_encoder(torch_sd: Dict[str, Any], cfg: T5Config | None = None):
    cfg = cfg or T5_XXL
    model = T5Encoder(cfg, device="meta")
    params = torch_to_flax(model)
    report = ConversionReport()
    sd = {k: as_tensor(v) for k, v in torch_sd.items()}
    sd.pop("encoder.embed_tokens.weight", None)   # tied to shared

    def take(src, dst, tf=None):
        if src in sd:
            put(params, f"params/{dst}", tf(sd.pop(src)) if tf else sd.pop(src),
                report)
        else:
            report.missing_src.append(src)

    take("shared.weight", "shared/embedding")
    for i in range(cfg.num_layers):
        src = f"encoder.block.{i}.layer"
        dst = f"block{i}"
        for p in ("q", "k", "v", "o"):
            take(f"{src}.0.SelfAttention.{p}.weight", f"{dst}/attn/{p}/kernel",
                 dense_kernel)
        if i == 0:
            take(f"{src}.0.SelfAttention.relative_attention_bias.weight",
                 f"{dst}/attn/relative_attention_bias")
        take(f"{src}.0.layer_norm.weight", f"{dst}/ln1/scale")
        for p in ("wi_0", "wi_1", "wo"):
            take(f"{src}.1.DenseReluDense.{p}.weight", f"{dst}/{p}/kernel",
                 dense_kernel)
        take(f"{src}.1.layer_norm.weight", f"{dst}/ln2/scale")
    take("encoder.final_layer_norm.weight", "final_norm/scale")

    report.unused_src.extend(sd.keys())
    return filled(params, model), report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--clip_ckpt", default=None)
    parser.add_argument("--t5_ckpt", default=None)
    parser.add_argument("--clip_tokenizer_dir", default=None,
                        help="dir with vocab.json+merges.txt (default: the "
                             "FLUX repo's tokenizer/ next to --clip_ckpt)")
    parser.add_argument("--t5_tokenizer_dir", default=None,
                        help="dir with tokenizer.json or spiece.model "
                             "(default: tokenizer_2/ next to --t5_ckpt)")
    args = parser.parse_args(argv)
    if args.clip_ckpt:
        sd = load_checkpoint(args.clip_ckpt)
        params, report = convert_clip_text(sd)
        print("clip:", report.summary())
        print("saved ->", save_params("flux_clip", params))
        tdir = args.clip_tokenizer_dir or os.path.join(
            os.path.dirname(os.path.dirname(args.clip_ckpt)), "tokenizer")
        files = {n: os.path.join(tdir, n) for n in ("vocab.json", "merges.txt")
                 if os.path.exists(os.path.join(tdir, n))}
        if len(files) == 2:
            print("clip tokenizer ->",
                  install_tokenizer_files("flux_clip", files))
        else:
            print(f"WARNING: no CLIP vocab.json+merges.txt under {tdir} — "
                  "inpainting will refuse to run with these params")
    if args.t5_ckpt:
        sd = load_checkpoint(args.t5_ckpt)
        params, report = convert_t5_encoder(sd)
        print("t5:", report.summary())
        print("saved ->", save_params("flux_t5", params))
        tdir = args.t5_tokenizer_dir or os.path.join(
            os.path.dirname(os.path.dirname(args.t5_ckpt)), "tokenizer_2")
        files = {n: os.path.join(tdir, n)
                 for n in ("tokenizer.json", "spiece.model")
                 if os.path.exists(os.path.join(tdir, n))}
        if files:
            print("t5 tokenizer ->",
                  install_tokenizer_files("flux_t5", files))
        else:
            print(f"WARNING: no T5 tokenizer.json/spiece.model under {tdir} — "
                  "inpainting will refuse to run with these params")


if __name__ == "__main__":
    main()
