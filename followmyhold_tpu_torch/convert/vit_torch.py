"""Generic timm/ViTPose/DINOv2-style torch ViT -> models.vit conversion (the
port's copy of the reference's ``convert/vit_torch.py``).

Covers the encoder layout shared by HaMeR's backbone, DINOv2 (MoGe's
backbone) and the Hunyuan conditioner's encoder: patch_embed.proj conv,
pos_embed, optional cls_token/register_tokens, blocks[i].{norm1, attn.qkv,
attn.proj, norm2, mlp.fc1, mlp.fc2, ls1.gamma, ls2.gamma}, final norm, and
DINOv2-G's fused SwiGLU (mlp.w12/w3).

The Flax tree folds depth with nn.scan, so per-layer torch tensors are
STACKED along a leading depth axis at {root}/blocks/block/....
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from followmyhold_tpu_torch.convert.common import (
    ConversionReport,
    as_tensor,
    conv_kernel,
    dense_kernel,
    put,
)

# torch per-block key -> (flax subpath under blocks/block, transform)
_BLOCK_MAP = [
    ("norm1.weight", "norm1/scale", None),
    ("norm1.bias", "norm1/bias", None),
    ("attn.qkv.weight", "attn/qkv/kernel", dense_kernel),
    ("attn.qkv.bias", "attn/qkv/bias", None),
    ("attn.proj.weight", "attn/proj/kernel", dense_kernel),
    ("attn.proj.bias", "attn/proj/bias", None),
    ("norm2.weight", "norm2/scale", None),
    ("norm2.bias", "norm2/bias", None),
    ("mlp.fc1.weight", "mlp/fc1/kernel", dense_kernel),
    ("mlp.fc1.bias", "mlp/fc1/bias", None),
    ("mlp.fc2.weight", "mlp/fc2/kernel", dense_kernel),
    ("mlp.fc2.bias", "mlp/fc2/bias", None),
]
_BLOCK_OPTIONAL = [("ls1.gamma", "ls1", None), ("ls2.gamma", "ls2", None)]
# dinov2-giant fused SwiGLU FFN (mlp.w12/w3) replaces mlp.fc1/fc2
_BLOCK_SWIGLU = [
    ("mlp.w12.weight", "mlp/w12/kernel", dense_kernel),
    ("mlp.w12.bias", "mlp/w12/bias", None),
    ("mlp.w3.weight", "mlp/w3/kernel", dense_kernel),
    ("mlp.w3.bias", "mlp/w3/bias", None),
]


def convert_vit(
    torch_sd: Dict[str, Any],
    flax_params: Dict[str, Any],
    prefix: str = "",
    flax_prefix: str = "params",
    depth: int | None = None,
    report: ConversionReport | None = None,
) -> ConversionReport:
    """Map a torch ViT state dict (keys under `prefix`) onto a ViT param tree
    rooted at flax_params[flax_prefix]."""
    report = report or ConversionReport()
    sd = {k[len(prefix):]: as_tensor(v) for k, v in torch_sd.items()
          if k.startswith(prefix)}

    def grab(key):
        if key in sd:
            return sd.pop(key)
        report.missing_src.append(prefix + key)
        return None

    root = flax_prefix

    v = grab("patch_embed.proj.weight")
    if v is not None:
        put(flax_params, f"{root}/patch_embed/kernel", conv_kernel(v), report)
    v = grab("patch_embed.proj.bias")
    if v is not None:
        put(flax_params, f"{root}/patch_embed/bias", v, report)
    v = grab("pos_embed")
    if v is not None:
        put(flax_params, f"{root}/pos_embed", v, report)
    for src, dst in (("cls_token", "cls_token"),
                     ("register_tokens", "register_tokens")):
        if src in sd:
            put(flax_params, f"{root}/{dst}", sd.pop(src), report)

    if depth is None:
        depth = 1 + max(
            (int(k.split(".")[1]) for k in sd if k.startswith("blocks.")),
            default=-1)

    # stack per-layer tensors along a leading depth axis
    block_map = list(_BLOCK_MAP)
    if "blocks.0.mlp.w12.weight" in sd:
        block_map = [m for m in block_map if not m[0].startswith("mlp.")]
        block_map += _BLOCK_SWIGLU
    if "blocks.0.ls1.gamma" in sd:
        block_map += _BLOCK_OPTIONAL
    for src_rel, dst_rel, tf in block_map:
        layers = []
        ok = True
        for i in range(depth):
            key = f"blocks.{i}.{src_rel}"
            if key not in sd:
                report.missing_src.append(prefix + key)
                ok = False
                continue
            v = sd.pop(key)
            layers.append(tf(v) if tf else v)
        if ok and layers:
            put(flax_params, f"{root}/blocks/block/{dst_rel}",
                torch.stack(layers), report)

    for src, dst in (("norm.weight", f"{root}/norm/scale"),
                     ("norm.bias", f"{root}/norm/bias"),
                     ("last_norm.weight", f"{root}/norm/scale"),
                     ("last_norm.bias", f"{root}/norm/bias")):
        if src in sd:
            put(flax_params, dst, sd.pop(src), report)

    report.unused_src.extend(prefix + k for k in sd)
    return report
