"""FLUX.1(-Kontext) transformer + VAE checkpoint -> the ``flux_transformer``
and ``flux_vae`` parameter files (the port's copy of the reference's
``convert/flux.py``).

Maps the diffusers layouts (FluxTransformer2DModel, AutoencoderKL with 16
latent channels) onto models/flux.{FluxTransformer,FluxVae}. The mapping is
declared as an explicit (torch_name, flax_path, kind) table so tests can
synthesize layout-exact state dicts and prove 100% coverage.

    python -m followmyhold_tpu_torch.convert.flux --transformer diffusion_pytorch_model.bin
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Tuple

from followmyhold_tpu_torch.convert.common import (
    ConversionReport,
    as_tensor,
    conv_kernel,
    dense_kernel,
    filled,
    load_checkpoint,
    put,
)
from followmyhold_tpu_torch.models.flux import (
    FLUX_DEV,
    FLUX_VAE,
    FluxConfig,
    FluxTransformer,
    FluxVae,
    FluxVaeConfig,
)
from followmyhold_tpu_torch.utils.params import save_params, torch_to_flax

Map = List[Tuple[str, str, str]]   # (torch prefix, flax path, kind)


def _dense(m: Map, src, dst):
    m.append((f"{src}.weight", f"{dst}/kernel", "dense"))
    m.append((f"{src}.bias", f"{dst}/bias", "raw"))


def flux_transformer_mapping(cfg: FluxConfig) -> Map:
    m: Map = []
    _dense(m, "x_embedder", "x_embedder")
    _dense(m, "context_embedder", "context_embedder")
    for tower, dst in (("timestep_embedder", "timestep_embedder"),
                       ("guidance_embedder", "guidance_embedder"),
                       ("text_embedder", "text_embedder")):
        if tower == "guidance_embedder" and not cfg.guidance_embeds:
            continue
        _dense(m, f"time_text_embed.{tower}.linear_1", f"{dst}/linear_1")
        _dense(m, f"time_text_embed.{tower}.linear_2", f"{dst}/linear_2")
    for i in range(cfg.num_layers):
        src = f"transformer_blocks.{i}"
        dst = f"double{i}"
        _dense(m, f"{src}.norm1.linear", f"{dst}/norm1_linear")
        _dense(m, f"{src}.norm1_context.linear", f"{dst}/norm1_context_linear")
        for p in ("to_q", "to_k", "to_v"):
            _dense(m, f"{src}.attn.{p}", f"{dst}/{p}")
        for p in ("add_q_proj", "add_k_proj", "add_v_proj"):
            _dense(m, f"{src}.attn.{p}", f"{dst}/{p}")
        m.append((f"{src}.attn.norm_q.weight", f"{dst}/norm_q/scale", "raw"))
        m.append((f"{src}.attn.norm_k.weight", f"{dst}/norm_k/scale", "raw"))
        m.append((f"{src}.attn.norm_added_q.weight",
                  f"{dst}/norm_added_q/scale", "raw"))
        m.append((f"{src}.attn.norm_added_k.weight",
                  f"{dst}/norm_added_k/scale", "raw"))
        _dense(m, f"{src}.attn.to_out.0", f"{dst}/to_out")
        _dense(m, f"{src}.attn.to_add_out", f"{dst}/to_add_out")
        _dense(m, f"{src}.ff.net.0.proj", f"{dst}/ff_in")
        _dense(m, f"{src}.ff.net.2", f"{dst}/ff_out")
        _dense(m, f"{src}.ff_context.net.0.proj", f"{dst}/ff_context_in")
        _dense(m, f"{src}.ff_context.net.2", f"{dst}/ff_context_out")
    for i in range(cfg.num_single_layers):
        src = f"single_transformer_blocks.{i}"
        dst = f"single{i}"
        _dense(m, f"{src}.norm.linear", f"{dst}/norm_linear")
        for p in ("to_q", "to_k", "to_v"):
            _dense(m, f"{src}.attn.{p}", f"{dst}/{p}")
        m.append((f"{src}.attn.norm_q.weight", f"{dst}/norm_q/scale", "raw"))
        m.append((f"{src}.attn.norm_k.weight", f"{dst}/norm_k/scale", "raw"))
        _dense(m, f"{src}.proj_mlp", f"{dst}/proj_mlp")
        _dense(m, f"{src}.proj_out", f"{dst}/proj_out")
    _dense(m, "norm_out.linear", "norm_out_linear")
    _dense(m, "proj_out", "proj_out")
    return m


def _resnet(m: Map, src, dst, has_shortcut):
    for p in ("norm1", "norm2"):
        m.append((f"{src}.{p}.weight", f"{dst}/{p}/scale", "raw"))
        m.append((f"{src}.{p}.bias", f"{dst}/{p}/bias", "raw"))
    for p in ("conv1", "conv2"):
        m.append((f"{src}.{p}.weight", f"{dst}/{p}/kernel", "conv"))
        m.append((f"{src}.{p}.bias", f"{dst}/{p}/bias", "raw"))
    if has_shortcut:
        m.append((f"{src}.conv_shortcut.weight", f"{dst}/conv_shortcut/kernel",
                  "conv"))
        m.append((f"{src}.conv_shortcut.bias", f"{dst}/conv_shortcut/bias",
                  "raw"))


def _mid(m: Map, src, dst):
    _resnet(m, f"{src}.resnets.0", f"{dst}_res0", False)
    _resnet(m, f"{src}.resnets.1", f"{dst}_res1", False)
    a = f"{src}.attentions.0"
    m.append((f"{a}.group_norm.weight", f"{dst}_attn/group_norm/scale", "raw"))
    m.append((f"{a}.group_norm.bias", f"{dst}_attn/group_norm/bias", "raw"))
    for p in ("to_q", "to_k", "to_v"):
        _dense(m, f"{a}.{p}", f"{dst}_attn/{p}")
    _dense(m, f"{a}.to_out.0", f"{dst}_attn/to_out")


def flux_vae_mapping(cfg: FluxVaeConfig) -> Map:
    m: Map = []
    chans = cfg.block_out_channels
    m.append(("encoder.conv_in.weight", "enc/conv_in/kernel", "conv"))
    m.append(("encoder.conv_in.bias", "enc/conv_in/bias", "raw"))
    prev = chans[0]
    for b, ch in enumerate(chans):
        for l in range(cfg.layers_per_block):
            _resnet(m, f"encoder.down_blocks.{b}.resnets.{l}",
                    f"enc/down{b}_res{l}",
                    has_shortcut=(l == 0 and ch != prev))
        prev = ch
        if b < len(chans) - 1:
            m.append((f"encoder.down_blocks.{b}.downsamplers.0.conv.weight",
                      f"enc/down{b}_conv/kernel", "conv"))
            m.append((f"encoder.down_blocks.{b}.downsamplers.0.conv.bias",
                      f"enc/down{b}_conv/bias", "raw"))
    _mid(m, "encoder.mid_block", "enc/mid")
    m.append(("encoder.conv_norm_out.weight", "enc/conv_norm_out/scale", "raw"))
    m.append(("encoder.conv_norm_out.bias", "enc/conv_norm_out/bias", "raw"))
    m.append(("encoder.conv_out.weight", "enc/conv_out/kernel", "conv"))
    m.append(("encoder.conv_out.bias", "enc/conv_out/bias", "raw"))

    rev = tuple(reversed(chans))
    m.append(("decoder.conv_in.weight", "dec/conv_in/kernel", "conv"))
    m.append(("decoder.conv_in.bias", "dec/conv_in/bias", "raw"))
    _mid(m, "decoder.mid_block", "dec/mid")
    prev = rev[0]
    for b, ch in enumerate(rev):
        for l in range(cfg.layers_per_block + 1):
            _resnet(m, f"decoder.up_blocks.{b}.resnets.{l}",
                    f"dec/up{b}_res{l}",
                    has_shortcut=(l == 0 and ch != prev))
        prev = ch
        if b < len(rev) - 1:
            m.append((f"decoder.up_blocks.{b}.upsamplers.0.conv.weight",
                      f"dec/up{b}_conv/kernel", "conv"))
            m.append((f"decoder.up_blocks.{b}.upsamplers.0.conv.bias",
                      f"dec/up{b}_conv/bias", "raw"))
    m.append(("decoder.conv_norm_out.weight", "dec/conv_norm_out/scale", "raw"))
    m.append(("decoder.conv_norm_out.bias", "dec/conv_norm_out/bias", "raw"))
    m.append(("decoder.conv_out.weight", "dec/conv_out/kernel", "conv"))
    m.append(("decoder.conv_out.bias", "dec/conv_out/bias", "raw"))
    return m


_TF = {"dense": dense_kernel, "conv": conv_kernel, "raw": None}


def _apply_mapping(mapping: Map, torch_sd, params, report):
    sd = {k: as_tensor(v) for k, v in torch_sd.items()}
    for src, dst, kind in mapping:
        if src in sd:
            v = sd.pop(src)
            tf = _TF[kind]
            put(params, f"params/{dst}", tf(v) if tf else v, report)
        else:
            report.missing_src.append(src)
    report.unused_src.extend(sd.keys())
    return params, report


def convert_flux_transformer(torch_sd: Dict[str, Any],
                             cfg: FluxConfig | None = None, n_tokens: int = 8):
    cfg = cfg or FLUX_DEV
    model = FluxTransformer(cfg, device="meta")
    params, report = _apply_mapping(flux_transformer_mapping(cfg), torch_sd,
                                    torch_to_flax(model), ConversionReport())
    return filled(params, model), report


def convert_flux_vae(torch_sd: Dict[str, Any],
                     cfg: FluxVaeConfig | None = None, size: int = 64):
    cfg = cfg or FLUX_VAE
    model = FluxVae(cfg, device="meta")
    params, report = _apply_mapping(flux_vae_mapping(cfg), torch_sd,
                                    torch_to_flax(model), ConversionReport())
    return filled(params, model), report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--transformer", default=None)
    parser.add_argument("--vae", default=None)
    args = parser.parse_args(argv)
    if args.transformer:
        sd = load_checkpoint(args.transformer)
        params, report = convert_flux_transformer(sd)
        print("transformer:", report.summary())
        print("saved ->", save_params("flux_transformer", params))
        if report.missing_src or report.unused_src:
            print("drift:", report.missing_src[:6], report.unused_src[:6])
    if args.vae:
        sd = load_checkpoint(args.vae)
        params, report = convert_flux_vae(sd)
        print("vae:", report.summary())
        print("saved ->", save_params("flux_vae", params))
        if report.missing_src or report.unused_src:
            print("drift:", report.missing_src[:6], report.unused_src[:6])


if __name__ == "__main__":
    main()
