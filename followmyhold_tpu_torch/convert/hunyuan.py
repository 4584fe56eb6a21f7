"""Hunyuan3D-2 torch checkpoint -> parameter files (DiT + ShapeVAE +
conditioner); the port's copy of the reference's ``convert/hunyuan.py``.

The reference loads ckpt['model'] / ckpt['vae'] / ckpt['conditioner'] from
model.ckpt (pipelines.py:477-499). The DiT is FLUX-style (double_blocks.N /
single_blocks.N with img/txt streams), the VAE a vecset transformer with a
cross-attention geo decoder. This maps those layouts onto models/hunyuan.*;
the ConversionReport surfaces any naming drift in a given checkpoint revision.
The three files are ``hunyuan_dit``, ``hunyuan_vae`` and ``hunyuan_cond``,
the names ``geometry/hunyuan.build_models`` loads.

    python -m followmyhold_tpu_torch.convert.hunyuan --ckpt model.ckpt
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
from followmyhold_tpu_torch.models.hunyuan import (
    Conditioner,
    ConditionerConfig,
    DiTConfig,
    HunyuanDiT,
    ShapeVAE,
    ShapeVAEConfig,
)
from followmyhold_tpu_torch.utils.params import save_params, save_scheduler_config, torch_to_flax

def _stacker(sd, params, report, prefix: str = ""):
    """take_stacked(depth, src_fmt, dst, tf): the per-layer tensors
    ``prefix + src_fmt.format(i=i)`` stacked on a leading axis into ``dst``,
    or each missing key listed and ``dst`` left alone."""

    def take_stacked(depth, src_fmt, dst, tf=None):
        stacked = []
        ok = True
        for i in range(depth):
            key = prefix + src_fmt.format(i=i)
            if key in sd:
                v = sd.pop(key)
                stacked.append(tf(v) if tf else v)
            else:
                report.missing_src.append(key)
                ok = False
        if ok and stacked:
            put(params, dst, torch.stack(stacked), report)

    return take_stacked


def convert_dit(sd: Dict[str, Any], cfg: DiTConfig | None = None,
                cond_tokens: int = 1370):
    cfg = cfg or DiTConfig()
    model = HunyuanDiT(cfg, device="meta")
    params = torch_to_flax(model)
    report = ConversionReport()
    sd = {k: as_tensor(v) for k, v in sd.items()}

    def take(src, dst, tf=None):
        if src in sd:
            v = sd.pop(src)
            put(params, dst, tf(v) if tf else v, report)
        else:
            report.missing_src.append(src)

    take("latent_in.weight", "params/latent_in/kernel", dense_kernel)
    take("latent_in.bias", "params/latent_in/bias")
    take("cond_in.weight", "params/cond_in/kernel", dense_kernel)
    take("cond_in.bias", "params/cond_in/bias")
    for n, fl in (("time_in.in_layer", "time_in/in_layer"),
                  ("time_in.out_layer", "time_in/out_layer")):
        take(f"{n}.weight", f"params/{fl}/kernel", dense_kernel)
        take(f"{n}.bias", f"params/{fl}/bias")

    take_stacked = _stacker(sd, params, report)

    if cfg.guidance_embed:
        for n, fl in (("guidance_in.in_layer", "guidance_in/in_layer"),
                      ("guidance_in.out_layer", "guidance_in/out_layer")):
            take(f"{n}.weight", f"params/{fl}/kernel", dense_kernel)
            take(f"{n}.bias", f"params/{fl}/bias")

    # nn.scan layout: per-layer tensors stacked along a leading depth axis
    for stream in ("img", "txt"):
        for src_rel, dst_rel, tf in (
            (f"{stream}_mod.lin.weight", f"{stream}_mod/lin/kernel", dense_kernel),
            (f"{stream}_mod.lin.bias", f"{stream}_mod/lin/bias", None),
            (f"{stream}_attn.qkv.weight", f"{stream}_qkv/kernel", dense_kernel),
            (f"{stream}_attn.qkv.bias", f"{stream}_qkv/bias", None),
            (f"{stream}_attn.norm.query_norm.scale", f"{stream}_qnorm/scale", None),
            (f"{stream}_attn.norm.key_norm.scale", f"{stream}_knorm/scale", None),
            (f"{stream}_attn.proj.weight", f"{stream}_proj/kernel", dense_kernel),
            (f"{stream}_attn.proj.bias", f"{stream}_proj/bias", None),
            (f"{stream}_mlp.0.weight", f"{stream}_mlp1/kernel", dense_kernel),
            (f"{stream}_mlp.0.bias", f"{stream}_mlp1/bias", None),
            (f"{stream}_mlp.2.weight", f"{stream}_mlp2/kernel", dense_kernel),
            (f"{stream}_mlp.2.bias", f"{stream}_mlp2/bias", None),
        ):
            take_stacked(cfg.depth_double, "double_blocks.{i}." + src_rel,
                         f"params/double_blocks/block/{dst_rel}", tf)

    for src_rel, dst_rel, tf in (
        ("modulation.lin.weight", "mod/lin/kernel", dense_kernel),
        ("modulation.lin.bias", "mod/lin/bias", None),
        ("norm.query_norm.scale", "qnorm/scale", None),
        ("norm.key_norm.scale", "knorm/scale", None),
        ("linear1.weight", "linear1/kernel", dense_kernel),
        ("linear1.bias", "linear1/bias", None),
        ("linear2.weight", "linear2/kernel", dense_kernel),
        ("linear2.bias", "linear2/bias", None),
    ):
        take_stacked(cfg.depth_single, "single_blocks.{i}." + src_rel,
                     f"params/single_blocks/block/{dst_rel}", tf)

    take("final_layer.adaLN_modulation.1.weight", "params/final_mod/lin/kernel",
         dense_kernel)
    take("final_layer.adaLN_modulation.1.bias", "params/final_mod/lin/bias")
    take("final_layer.linear.weight", "params/final_proj/kernel", dense_kernel)
    take("final_layer.linear.bias", "params/final_proj/bias")

    report.unused_src.extend(sd.keys())
    return filled(params, model), report


def convert_vae(sd: Dict[str, Any], cfg: ShapeVAEConfig | None = None):
    cfg = cfg or ShapeVAEConfig()
    model = ShapeVAE(cfg, device="meta")
    params = torch_to_flax(model)
    report = ConversionReport()
    sd = {k: as_tensor(v) for k, v in sd.items()}

    def take(src, dst, tf=None):
        if src in sd:
            put(params, dst, tf(sd.pop(src)) if tf else sd.pop(src), report)
        else:
            report.missing_src.append(src)

    take("post_kl.weight", "params/decoder/post_kl/kernel", dense_kernel)
    take("post_kl.bias", "params/decoder/post_kl/bias")

    take_stacked = _stacker(sd, params, report)

    for src_rel, dst_rel, tf in (
        ("ln_1.weight", "ln1/scale", None),
        ("ln_1.bias", "ln1/bias", None),
        ("attn.c_qkv.weight", "qkv/kernel", dense_kernel),
        ("attn.c_qkv.bias", "qkv/bias", None),
        ("attn.c_proj.weight", "proj/kernel", dense_kernel),
        ("attn.c_proj.bias", "proj/bias", None),
        ("ln_2.weight", "ln2/scale", None),
        ("ln_2.bias", "ln2/bias", None),
        ("mlp.c_fc.weight", "fc1/kernel", dense_kernel),
        ("mlp.c_fc.bias", "fc1/bias", None),
        ("mlp.c_proj.weight", "fc2/kernel", dense_kernel),
        ("mlp.c_proj.bias", "fc2/bias", None),
    ):
        take_stacked(cfg.depth, "transformer.resblocks.{i}." + src_rel,
                     f"params/decoder/blocks/block/{dst_rel}", tf)
    take("ln_post.weight", "params/decoder/ln_post/scale")
    take("ln_post.bias", "params/decoder/ln_post/bias")

    # geo decoder: Michelangelo/vecset CrossAttentionDecoder —
    # query_proj + ResidualCrossAttentionBlock(ln_1/ln_2 pre-norms,
    # c_q/c_kv/c_proj cross-attention, ln_3 + c_fc/c_proj MLP) + ln_post +
    # output_proj (contract at pipelines.py:305)
    g = "geo_decoder.cross_attn_decoder"
    take("geo_decoder.query_proj.weight", "params/geo/query_in/kernel", dense_kernel)
    take("geo_decoder.query_proj.bias", "params/geo/query_in/bias")
    take(f"{g}.ln_1.weight", "params/geo/lnq/scale")
    take(f"{g}.ln_1.bias", "params/geo/lnq/bias")
    take(f"{g}.ln_2.weight", "params/geo/lnkv/scale")
    take(f"{g}.ln_2.bias", "params/geo/lnkv/bias")
    take(f"{g}.attn.c_q.weight", "params/geo/q/kernel", dense_kernel)
    take(f"{g}.attn.c_q.bias", "params/geo/q/bias")
    take(f"{g}.attn.c_kv.weight", "params/geo/kv/kernel", dense_kernel)
    take(f"{g}.attn.c_kv.bias", "params/geo/kv/bias")
    take(f"{g}.attn.c_proj.weight", "params/geo/proj/kernel", dense_kernel)
    take(f"{g}.attn.c_proj.bias", "params/geo/proj/bias")
    take(f"{g}.ln_3.weight", "params/geo/ln3/scale")
    take(f"{g}.ln_3.bias", "params/geo/ln3/bias")
    take(f"{g}.mlp.c_fc.weight", "params/geo/fc1/kernel", dense_kernel)
    take(f"{g}.mlp.c_fc.bias", "params/geo/fc1/bias")
    take(f"{g}.mlp.c_proj.weight", "params/geo/fc2/kernel", dense_kernel)
    take(f"{g}.mlp.c_proj.bias", "params/geo/fc2/bias")
    take("geo_decoder.ln_post.weight", "params/geo/ln_out/scale")
    take("geo_decoder.ln_post.bias", "params/geo/ln_out/bias")
    take("geo_decoder.output_proj.weight", "params/geo/logit/kernel", dense_kernel)
    take("geo_decoder.output_proj.bias", "params/geo/logit/bias")

    report.unused_src.extend(sd.keys())
    return filled(params, model), report


def convert_conditioner(sd: Dict[str, Any], cfg: ConditionerConfig | None = None):
    """ckpt['conditioner'] -> Conditioner params.

    hy3dgen's SingleImageEncoder wraps a DINOv2-giant under
    main_image_encoder.model.*; both the HF Dinov2Model naming
    (embeddings./encoder.layer.N.) and the dinov2-repo/timm naming
    (patch_embed./blocks.N.) are handled — the released checkpoint's exact
    revision decides which branch fires (ConversionReport flags drift)."""
    cfg = cfg or ConditionerConfig()
    model = Conditioner(cfg, device="meta")
    params = torch_to_flax(model)
    report = ConversionReport()
    sd = {k: as_tensor(v) for k, v in sd.items()}

    for k in list(sd):
        if "unconditional_embedding" in k or k.endswith("uncond_embedding"):
            put(params, "params/uncond_embedding", sd.pop(k), report)

    root = "params/encoder/encoder"
    timm_pfx = hf_pfx = None
    for k in sd:
        if k.endswith("patch_embed.proj.weight"):
            timm_pfx = k[: -len("patch_embed.proj.weight")]
            break
        if k.endswith("embeddings.patch_embeddings.projection.weight"):
            hf_pfx = k[: -len("embeddings.patch_embeddings.projection.weight")]
            break
    if timm_pfx is not None:
        from followmyhold_tpu_torch.convert.vit_torch import convert_vit

        sd.pop(f"{timm_pfx}mask_token", None)
        convert_vit(sd, params, prefix=timm_pfx, flax_prefix=root,
                    depth=cfg.depth, report=report)
        return filled(params, model), report
    if hf_pfx is None:
        report.missing_src.append("<no dinov2 patch-embed key found>")
        report.unused_src.extend(sd.keys())
        return filled(params, model), report

    def take(src, dst, tf=None):
        key = hf_pfx + src
        if key in sd:
            put(params, f"{root}/{dst}", tf(sd.pop(key)) if tf else sd.pop(key),
                report)
        else:
            report.missing_src.append(key)

    sd.pop(f"{hf_pfx}embeddings.mask_token", None)
    take("embeddings.cls_token", "cls_token")
    take("embeddings.position_embeddings", "pos_embed")
    take("embeddings.patch_embeddings.projection.weight",
         "patch_embed/kernel", conv_kernel)
    take("embeddings.patch_embeddings.projection.bias", "patch_embed/bias")

    stacker = _stacker(sd, params, report, prefix=hf_pfx)

    def take_stacked(src_fmt, dst, tf=None):
        stacker(cfg.depth, src_fmt, f"{root}/blocks/block/{dst}", tf)

    def qkv_cat(i, suffix):
        parts = []
        for name in ("query", "key", "value"):
            key = f"{hf_pfx}encoder.layer.{i}.attention.attention.{name}.{suffix}"
            if key not in sd:
                report.missing_src.append(key)
                return None
            parts.append(sd.pop(key))
        return torch.cat(parts, dim=0)

    qkv_w = [qkv_cat(i, "weight") for i in range(cfg.depth)]
    qkv_b = [qkv_cat(i, "bias") for i in range(cfg.depth)]
    if all(v is not None for v in qkv_w):
        put(params, f"{root}/blocks/block/attn/qkv/kernel",
            torch.stack([dense_kernel(v) for v in qkv_w]), report)
    if all(v is not None for v in qkv_b):
        put(params, f"{root}/blocks/block/attn/qkv/bias", torch.stack(qkv_b),
            report)

    for src_rel, dst_rel, tf in (
        ("norm1.weight", "norm1/scale", None),
        ("norm1.bias", "norm1/bias", None),
        ("attention.output.dense.weight", "attn/proj/kernel", dense_kernel),
        ("attention.output.dense.bias", "attn/proj/bias", None),
        ("layer_scale1.lambda1", "ls1", None),
        ("norm2.weight", "norm2/scale", None),
        ("norm2.bias", "norm2/bias", None),
        ("layer_scale2.lambda1", "ls2", None),
    ):
        take_stacked("encoder.layer.{i}." + src_rel, dst_rel, tf)
    if cfg.ffn == "swiglu":
        for src_rel, dst_rel in (("mlp.weights_in", "mlp/w12"),
                                 ("mlp.weights_out", "mlp/w3")):
            take_stacked("encoder.layer.{i}." + src_rel + ".weight",
                         dst_rel + "/kernel", dense_kernel)
            take_stacked("encoder.layer.{i}." + src_rel + ".bias",
                         dst_rel + "/bias")
    else:
        for src_rel, dst_rel in (("mlp.fc1", "mlp/fc1"), ("mlp.fc2", "mlp/fc2")):
            take_stacked("encoder.layer.{i}." + src_rel + ".weight",
                         dst_rel + "/kernel", dense_kernel)
            take_stacked("encoder.layer.{i}." + src_rel + ".bias",
                         dst_rel + "/bias")
    take("layernorm.weight", "norm/scale")
    take("layernorm.bias", "norm/bias")

    report.unused_src.extend(sd.keys())
    return filled(params, model), report


def _scheduler_config(parser, path: str) -> dict:
    """--scheduler_config: a JSON mapping, or YAML where the yaml module
    imports; hy3dgen's config.yaml nests it under scheduler.params."""
    import json

    with open(path) as f:
        text = f.read()
    try:
        sched_cfg = json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml
        except ImportError:
            parser.error(f"--scheduler_config {path}: not JSON, and reading YAML needs "
                         f"the yaml module, which is not installed")
        sched_cfg = yaml.safe_load(text)
    if not isinstance(sched_cfg, dict):
        parser.error(f"--scheduler_config {path}: "
                     f"expected a JSON/YAML mapping with a `shift` key, "
                     f"got {type(sched_cfg).__name__}")
    if "shift" not in sched_cfg and "scheduler" in sched_cfg:
        sub = sched_cfg["scheduler"]
        if not isinstance(sub, dict):
            parser.error(f"--scheduler_config {path}: "
                         f"`scheduler` section is not a mapping")
        sched_cfg = sub.get("params", sub)
        if not isinstance(sched_cfg, dict):
            parser.error(f"--scheduler_config {path}: "
                         f"`scheduler.params` is not a mapping")
    return sched_cfg


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--scheduler_config", default=None,
                        help="path to the checkpoint's scheduler config "
                             "(JSON, or YAML where the yaml module is "
                             "installed, with a `shift` key); saved next "
                             "to the params so every sampler honors it "
                             "(reference schedulers.py:199-202)")
    args = parser.parse_args(argv)
    ckpt = load_checkpoint(args.ckpt)
    sched_cfg = ckpt.get("scheduler_config") if isinstance(ckpt, dict) else None
    if args.scheduler_config:
        sched_cfg = _scheduler_config(parser, args.scheduler_config)
    if sched_cfg:
        print("saved ->", save_scheduler_config(
            {k: v for k, v in dict(sched_cfg).items()
             if isinstance(v, (int, float, str, bool))}))
    dit_params, r1 = convert_dit(ckpt["model"])
    print("dit:", r1.summary())
    vae_params, r2 = convert_vae(ckpt["vae"])
    print("vae:", r2.summary())
    print("saved ->", save_params("hunyuan_dit", dit_params))
    print("saved ->", save_params("hunyuan_vae", vae_params))
    reports = [(r1, "dit"), (r2, "vae")]
    if "conditioner" in ckpt:
        cond_params, r3 = convert_conditioner(ckpt["conditioner"])
        print("conditioner:", r3.summary())
        # the name geometry/hunyuan.build_models loads (the JAX converter's
        # "hunyuan_conditioner" is read by neither package)
        print("saved ->", save_params("hunyuan_cond", cond_params))
        reports.append((r3, "conditioner"))
    for r, name in reports:
        if r.missing_src or r.unused_src:
            print(f"[{name}] inspect naming drift: missing={r.missing_src[:10]} "
                  f"unused={r.unused_src[:10]}")


if __name__ == "__main__":
    main()
