"""Synthetic reference checkpoints: exact-name torch state dicts of every model
the converters read, at any configuration, with values from a seed.

The names are those of the published checkpoints (the layouts the converters
in ``followmyhold_tpu_torch/convert/`` map), written as rules from a path of
the model's Flax tree to its torch name; the shapes come from that tree
(``utils.params.torch_to_flax`` of the port module on the meta device): a
kernel [in, out] becomes a weight [out, in], a conv kernel [kh, kw, in, out]
a weight [out, in, kh, kw], a scan-stacked leaf one tensor a layer. A
BatchNorm the converter folds comes as its five tensors. Values come from
``draw(name, shape)``: ``seeded_draw`` gives torch tensors from a
``torch.Generator`` (on the card, at full width, in the published fp16), the
tests give numpy arrays.

    sd = state_dict("hunyuan_dit", DIT_FULL, seeded_draw(gen, torch.float16, "cuda"))
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Sequence, Tuple, Union

import torch

from followmyhold_tpu_torch.utils.params import torch_to_flax

Draw = Callable[[str, tuple], Any]
# (pattern over a leaf's module path or its whole path, torch name, layout)
Rule = Tuple[str, Union[str, Callable], str]


def seeded_draw(gen: torch.Generator, dtype: torch.dtype = torch.float16,
                device="cpu") -> Draw:
    """Values for a checkpoint of initialised scale: a matrix or conv weight
    N(0, 1/shape[1]), a bias or running mean N(0, 0.02^2), a running
    variance in [0.5, 1.5), a BatchNorm's counter 0, every other vector
    1 + N(0, 0.02^2)."""
    def draw(name: str, shape: tuple) -> torch.Tensor:
        if name.endswith("num_batches_tracked"):
            return torch.zeros((), dtype=torch.int64)
        noise = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        if len(shape) >= 2:
            value = noise / float(shape[1]) ** 0.5
        elif name.endswith(("bias", "running_mean")):
            value = 0.02 * noise
        elif name.endswith("running_var"):
            value = 1.0 + 0.5 * torch.tanh(noise)
        else:
            value = 1.0 + 0.02 * noise
        return value.to(dtype)

    return draw


def flat_shapes(module) -> Dict[str, tuple]:
    """'a/b/kernel' -> shape, from the port module (built on the meta device)."""
    out = {}

    def walk(node, pre):
        for k, v in node.items():
            p = f"{pre}/{k}" if pre else k
            if isinstance(v, dict):
                walk(v, p)
            else:
                out[p] = tuple(v.shape)

    walk(torch_to_flax(module)["params"], "")
    return out


def _torch_shape(leaf: str, shape: tuple, layout: str) -> tuple:
    if layout == "row":                       # a [d] vector stored as a [1, d] embedding
        return (1, *shape)
    if layout == "nchw":                      # NHWC in the tree
        return (shape[0], shape[3], shape[1], shape[2])
    if layout == "convt" and leaf == "kernel":   # HWIO -> torch's ConvTranspose IOHW
        return (shape[2], shape[3], shape[0], shape[1])
    if leaf == "kernel" and len(shape) == 2:
        return shape[::-1]
    if leaf == "kernel" and len(shape) == 4:
        return (shape[3], shape[2], shape[0], shape[1])
    return shape


def synth(module, rules: Sequence[Rule], draw: Draw, skip: Sequence[str] = ()) -> Dict[str, Any]:
    """A state dict with one tensor for every leaf of ``module``'s Flax tree.
    The first rule whose pattern matches the module path of a kernel, scale,
    bias or embedding (then ``.weight`` / ``.bias`` follows), else the leaf's
    whole path, gives the torch name; a
    scan-stacked leaf (``.../block/...``, ``.../layer/...``) gives one tensor
    a layer, its index put for ``{i}``. Leaves matching ``skip`` get none."""
    sd: Dict[str, Any] = {}
    for path, shape in flat_shapes(module).items():
        if any(re.fullmatch(s, path) for s in skip):
            continue
        *mod, leaf = path.split("/")
        stacked = any(p in ("block", "layer") for p in mod)
        named = leaf in ("kernel", "scale", "bias", "embedding")
        tries = [("/".join(mod), ".bias" if leaf == "bias" else ".weight")] if named else []
        for key, suffix in tries + [(path, "")]:
            hit = next(((re.fullmatch(p, key), r, lay) for p, r, lay in rules
                        if re.fullmatch(p, key)), None)
            if hit:
                m, repl, layout = hit
                name = (repl(m) if callable(repl) else m.expand(repl)) + suffix
                break
        else:
            raise KeyError(f"no rule names {path}")
        tshape = _torch_shape(leaf, shape[1:] if stacked else shape, layout)
        for i in range(shape[0] if stacked else 1):
            key = name.replace("{i}", str(i))
            sd[key] = draw(key, tshape)
    return sd


def add_bn(sd: Dict[str, Any], prefix: str, n: int, draw: Draw) -> None:
    """A BatchNorm's five tensors under ``prefix``."""
    for p in ("weight", "bias", "running_mean", "running_var"):
        sd[f"{prefix}.{p}"] = draw(f"{prefix}.{p}", (n,))
    sd[f"{prefix}.num_batches_tracked"] = draw(f"{prefix}.num_batches_tracked", ())


def _r(pattern: str, repl, layout: str = "") -> Rule:
    return (pattern, repl, layout)


# ---- the ViT encoder (timm / DINOv2 / ViTPose naming) --------------------- #

def vit_rules(flax_root: str, prefix: str, norm: str = "norm") -> List[Rule]:
    r = re.escape(flax_root)
    return [
        _r(rf"{r}/patch_embed", rf"{prefix}patch_embed.proj"),
        _r(rf"{r}/(pos_embed|cls_token|register_tokens)", rf"{prefix}\1"),
        _r(rf"{r}/blocks/block/(ls[12])", prefix + r"blocks.{i}.\1.gamma"),
        _r(rf"{r}/blocks/block/(\w+)/(\w+)", prefix + r"blocks.{i}.\1.\2"),
        _r(rf"{r}/blocks/block/(\w+)", prefix + r"blocks.{i}.\1"),
        _r(rf"{r}/norm", f"{prefix}{norm}"),
    ]


# ---- Hunyuan3D-2 (hy3dgen's model.ckpt: model, vae, conditioner) ---------- #

_DB, _SB = "double_blocks/block", "single_blocks/block"
_DIT_RULES = [
    _r(r"(latent_in|cond_in|final_proj)",
       lambda m: "final_layer.linear" if m.group(1) == "final_proj" else m.group(1)),
    _r(r"(time_in|guidance_in)/(in_layer|out_layer)", r"\1.\2"),
    _r(rf"{_DB}/(img|txt)_mod/lin", r"double_blocks.{i}.\1_mod.lin"),
    _r(rf"{_DB}/(img|txt)_qkv", r"double_blocks.{i}.\1_attn.qkv"),
    _r(rf"{_DB}/(img|txt)_qnorm/scale", r"double_blocks.{i}.\1_attn.norm.query_norm.scale"),
    _r(rf"{_DB}/(img|txt)_knorm/scale", r"double_blocks.{i}.\1_attn.norm.key_norm.scale"),
    _r(rf"{_DB}/(img|txt)_proj", r"double_blocks.{i}.\1_attn.proj"),
    _r(rf"{_DB}/(img|txt)_mlp1", r"double_blocks.{i}.\1_mlp.0"),
    _r(rf"{_DB}/(img|txt)_mlp2", r"double_blocks.{i}.\1_mlp.2"),
    _r(rf"{_SB}/mod/lin", "single_blocks.{i}.modulation.lin"),
    _r(rf"{_SB}/qnorm/scale", "single_blocks.{i}.norm.query_norm.scale"),
    _r(rf"{_SB}/knorm/scale", "single_blocks.{i}.norm.key_norm.scale"),
    _r(rf"{_SB}/(linear1|linear2)", r"single_blocks.{i}.\1"),
    _r(r"final_mod/lin", "final_layer.adaLN_modulation.1"),
]
_GEO = "geo_decoder.cross_attn_decoder"
_VAE_RULES = [
    _r(r"decoder/post_kl", "post_kl"),
    _r(r"decoder/ln_post", "ln_post"),
    _r(r"decoder/blocks/block/ln([12])", r"transformer.resblocks.{i}.ln_\1"),
    _r(r"decoder/blocks/block/(qkv|proj)", r"transformer.resblocks.{i}.attn.c_\1"),
    _r(r"decoder/blocks/block/fc1", "transformer.resblocks.{i}.mlp.c_fc"),
    _r(r"decoder/blocks/block/fc2", "transformer.resblocks.{i}.mlp.c_proj"),
    _r(r"geo/query_in", "geo_decoder.query_proj"),
    _r(r"geo/lnq", f"{_GEO}.ln_1"), _r(r"geo/lnkv", f"{_GEO}.ln_2"), _r(r"geo/ln3", f"{_GEO}.ln_3"),
    _r(r"geo/(q|kv|proj)", _GEO + r".attn.c_\1"),
    _r(r"geo/fc1", f"{_GEO}.mlp.c_fc"), _r(r"geo/fc2", f"{_GEO}.mlp.c_proj"),
    _r(r"geo/ln_out", "geo_decoder.ln_post"), _r(r"geo/logit", "geo_decoder.output_proj"),
]


def _hunyuan_cond(module, draw):
    """The conditioner in the dinov2-repo naming under main_image_encoder.model."""
    pfx = "main_image_encoder.model."
    sd = synth(module, vit_rules("encoder/encoder", pfx) + [
        _r(r"uncond_embedding", "main_image_encoder.unconditional_embedding")], draw)
    e = module.cfg.embed_dim
    sd[f"{pfx}mask_token"] = draw(f"{pfx}mask_token", (1, e))
    return sd


# ---- MoGe ----------------------------------------------------------------- #

_CONV_STACK = [
    _r(r"(\w+)/in(\d+)", r"\1.input_blocks.\2"),
    _r(r"(\w+)/res(\d+)_(\d+)/in_norm", r"\1.res_blocks.\2.\3.layers.0"),
    _r(r"(\w+)/res(\d+)_(\d+)/conv1/conv", r"\1.res_blocks.\2.\3.layers.2"),
    _r(r"(\w+)/res(\d+)_(\d+)/hidden_norm", r"\1.res_blocks.\2.\3.layers.3"),
    _r(r"(\w+)/res(\d+)_(\d+)/conv2/conv", r"\1.res_blocks.\2.\3.layers.5"),
    _r(r"(\w+)/res(\d+)_(\d+)/skip", r"\1.res_blocks.\2.\3.skip_connection"),
    _r(r"(\w+)/up(\d+)/conv0/conv", r"\1.resamplers.\2.0"),     # pixel shuffle
    _r(r"(\w+)/up(\d+)/conv1/conv", r"\1.resamplers.\2.2"),
    _r(r"(\w+)/out(\d+)", r"\1.output_blocks.\2"),
]


def _moge(module, draw):
    n_scale = len(module.cfg.scale_head_dims)
    return synth(module, vit_rules("backbone", "encoder.backbone.") + [
        _r(r"proj(\d+)", r"encoder.output_projections.\1"),
        _r(r"scale(\d+)", lambda m: f"scale_head.{2 * int(m.group(1))}"),
        _r(r"scale_out", f"scale_head.{2 * (n_scale - 1)}"),
    ] + _CONV_STACK, draw)


# ---- HaMeR and ViTPose ---------------------------------------------------- #

_LAYER = "mano_head.transformer.transformer.layers.{i}"
_HAMER_RULES = vit_rules("backbone/vit", "backbone.") + [
    _r(r"mano_head/(decpose|decshape|deccam|init_hand_pose|init_betas|init_cam)",
       r"mano_head.\1"),
    _r(r"mano_head/input_proj", "mano_head.transformer.to_token_embedding"),
    _r(r"mano_head/pos_embedding", "mano_head.transformer.pos_embedding"),
    _r(r"mano_head/layers/layer/norm_sa", f"{_LAYER}.0.norm"),
    _r(r"mano_head/layers/layer/sa/to_qkv", f"{_LAYER}.0.fn.to_qkv"),
    _r(r"mano_head/layers/layer/sa/to_out", f"{_LAYER}.0.fn.to_out.0"),
    _r(r"mano_head/layers/layer/norm_ca", f"{_LAYER}.1.norm"),
    _r(r"mano_head/layers/layer/ca/(to_q|to_kv)", _LAYER + r".1.fn.\1"),
    _r(r"mano_head/layers/layer/ca/to_out", f"{_LAYER}.1.fn.to_out.0"),
    _r(r"mano_head/layers/layer/norm_ff", f"{_LAYER}.2.norm"),
    _r(r"mano_head/layers/layer/ff1", f"{_LAYER}.2.fn.net.0"),
    _r(r"mano_head/layers/layer/ff2", f"{_LAYER}.2.fn.net.3"),
]


def _hamer(module, draw):
    sd = synth(module, _HAMER_RULES, draw)
    # HaMeR's checkpoint is Lightning's: the discriminator's tensors sit beside
    # the model's, and the converter leaves them
    sd["discriminator.D_conv1.weight"] = draw("discriminator.D_conv1.weight", (8, 3, 1, 1))
    return sd


def _vitpose(module, draw):
    """mmpose's top-down ViTPose: the timm ViT under backbone. (last_norm) and
    keypoint_head.deconv_layers.{0,3} ConvTranspose (no bias) with BatchNorms
    at {1,4}."""
    sd = synth(module, vit_rules("backbone", "backbone.", norm="last_norm") + [
        _r(r"deconv(\d+)", lambda m: f"keypoint_head.deconv_layers.{3 * int(m.group(1))}",
           "convt"),
        _r(r"final", "keypoint_head.final_layer"),
    ], draw, skip=[r"bn\d+_(scale|bias)", r"deconv\d+/bias"])
    for i in range(module.cfg.num_deconv):
        add_bn(sd, f"keypoint_head.deconv_layers.{3 * i + 1}", module.cfg.deconv_channels, draw)
    return sd


# ---- FLUX and its text towers -------------------------------------------- #

def _from_mapping(module, mapping, draw):
    """A state dict from a converter's (torch name, flax path, kind) table."""
    shapes = flat_shapes(module)
    sd = {}
    for src, dst, kind in mapping:
        leaf = dst.rsplit("/", 1)[-1]
        sd[src] = draw(src, _torch_shape(leaf if kind != "raw" else "", shapes[dst], ""))
    return sd


def _flux_transformer(module, draw):
    from followmyhold_tpu_torch.convert.flux import flux_transformer_mapping

    return _from_mapping(module, flux_transformer_mapping(module.cfg), draw)


def _flux_vae(module, draw):
    from followmyhold_tpu_torch.convert.flux import flux_vae_mapping

    return _from_mapping(module, flux_vae_mapping(module.cfg), draw)


def _clip(module, draw):
    tm = "text_model"
    sd = synth(module, [
        _r(r"token_embedding", f"{tm}.embeddings.token_embedding"),
        _r(r"position_embedding", f"{tm}.embeddings.position_embedding.weight"),
        _r(r"layer(\d+)/(q_proj|k_proj|v_proj|out_proj)", tm + r".encoder.layers.\1.self_attn.\2"),
        _r(r"layer(\d+)/(fc[12])", tm + r".encoder.layers.\1.mlp.\2"),
        _r(r"layer(\d+)/(layer_norm[12])", tm + r".encoder.layers.\1.\2"),
        _r(r"final_layer_norm", f"{tm}.final_layer_norm"),
    ], draw)
    sd[f"{tm}.embeddings.position_ids"] = torch.arange(
        module.cfg.max_position_embeddings, dtype=torch.int64)[None]
    return sd


def _t5(module, draw):
    b = r"encoder.block.\1.layer"
    sd = synth(module, [
        _r(r"shared", "shared"),
        _r(r"block(\d+)/attn/relative_attention_bias",
           b + ".0.SelfAttention.relative_attention_bias.weight"),
        _r(r"block(\d+)/attn/(q|k|v|o)", b + r".0.SelfAttention.\2"),
        _r(r"block(\d+)/ln1", b + ".0.layer_norm"),
        _r(r"block(\d+)/(wi_0|wi_1|wo)", b + r".1.DenseReluDense.\2"),
        _r(r"block(\d+)/ln2", b + ".1.layer_norm"),
        _r(r"final_norm", "encoder.final_layer_norm"),
    ], draw)
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"]     # tied
    return sd


# ---- YOLOv8 and the Faster R-CNN (convolutions with BatchNorms) ----------- #

def yolo_name(flax_path: str) -> str:
    """'m2/m0/cv1' -> '2.m.0.cv1'; 'm22/cv2_1_0' -> '22.cv2.1.0' (the inverse
    of the converter's ``_map_name``)."""
    parts = flax_path.split("/")
    out = [parts[0][1:]]
    for p in parts[1:]:
        mm = re.fullmatch(r"m(\d+)", p)
        hd = re.fullmatch(r"(cv[23])_(\d+)_(\d+)", p)
        if mm:
            out += ["m", mm.group(1)]
        elif hd:
            out += [hd.group(1), hd.group(2), hd.group(3)]
        else:
            out.append(p)
    return ".".join(out)


def _yolov8(module, draw):
    """The ultralytics layout: every ``<m>/conv`` a conv with a BatchNorm, the
    Detect head's last 1x1s plain convs, and the fixed DFL conv."""
    sd = {}
    for path, shape in flat_shapes(module).items():
        names = path.split("/")
        if names[-1] != "kernel":
            continue
        wshape = _torch_shape("kernel", shape, "")
        if names[-2] == "conv":
            base = "model." + yolo_name("/".join(names[:-2]))
            sd[f"{base}.conv.weight"] = draw(f"{base}.conv.weight", wshape)
            add_bn(sd, f"{base}.bn", shape[3], draw)
        else:
            base = "model." + yolo_name("/".join(names[:-1]))
            sd[f"{base}.weight"] = draw(f"{base}.weight", wshape)
            sd[f"{base}.bias"] = draw(f"{base}.bias", (shape[3],))
    sd["model.22.dfl.conv.weight"] = torch.arange(16, dtype=torch.float32).reshape(1, 16, 1, 1)
    return sd


_FRCNN_LAYERS = {"layer1": "RCNN_base.4", "layer2": "RCNN_base.5",
                 "layer3": "RCNN_base.6", "layer4": "RCNN_top.0"}


def _hand_object(module, draw):
    """The hand_object_detector layout: caffe ResNet convs with frozen
    BatchNorms (no conv bias), the RPN and the heads."""
    sd = synth(module, [
        _r(r"rpn_conv", "RCNN_rpn.RPN_Conv"), _r(r"rpn_cls", "RCNN_rpn.RPN_cls_score"),
        _r(r"rpn_box", "RCNN_rpn.RPN_bbox_pred"), _r(r"cls_score", "RCNN_cls_score"),
        _r(r"bbox_pred", "RCNN_bbox_pred"),
        _r(r"ext_contact1", "extension_layer.hand_contact_state_layer.0"),
        _r(r"ext_contact2", "extension_layer.hand_contact_state_layer.3"),
        _r(r"ext_dydx", "extension_layer.hand_dydx_layer"),
        _r(r"ext_lr", "extension_layer.hand_lr_layer"),
    ], draw, skip=[r".*/conv/(kernel|bias)"])
    for path, shape in flat_shapes(module).items():
        m = re.fullmatch(r"(.*)/conv/kernel", path)
        if not m:
            continue
        parts = m.group(1).split("/")
        if parts == ["conv1"]:
            conv, bn = "RCNN_base.0", "RCNN_base.1"
        else:
            layer, block, name = parts
            base = f"{_FRCNN_LAYERS[layer]}.{block[len('block'):]}"
            conv, bn = ((f"{base}.downsample.0", f"{base}.downsample.1")
                        if name == "downsample" else (f"{base}.{name}", f"{base}.bn{name[-1]}"))
        sd[f"{conv}.weight"] = draw(f"{conv}.weight", _torch_shape("kernel", shape, ""))
        add_bn(sd, bn, shape[3], draw)
    return sd


# ---- GroundingDINO (the HF layout) and SAM2 ------------------------------- #

_BB = "model.backbone.conv_encoder.model"
_TB = "model.text_backbone"
_GDINO_RULES = [
    _r(r"backbone/patch_embed", f"{_BB}.embeddings.patch_embeddings.projection"),
    _r(r"backbone/embed_norm", f"{_BB}.embeddings.norm"),
    _r(r"backbone/stage(\d+)_block(\d+)/attn/relative_position_bias_table",
       _BB + r".encoder.layers.\1.blocks.\2.attention.self.relative_position_bias_table"),
    _r(r"backbone/stage(\d+)_block(\d+)/attn/(query|key|value)",
       _BB + r".encoder.layers.\1.blocks.\2.attention.self.\3"),
    _r(r"backbone/stage(\d+)_block(\d+)/attn/proj",
       _BB + r".encoder.layers.\1.blocks.\2.attention.output.dense"),
    _r(r"backbone/stage(\d+)_block(\d+)/(intermediate|output)",
       _BB + r".encoder.layers.\1.blocks.\2.\3.dense"),
    _r(r"backbone/stage(\d+)_block(\d+)/(layernorm_before|layernorm_after)",
       _BB + r".encoder.layers.\1.blocks.\2.\3"),
    _r(r"backbone/downsample(\d+)/(reduction|norm)", _BB + r".encoder.layers.\1.downsample.\2"),
    _r(r"backbone/out_norm(\d+)", _BB + r".hidden_states_norms.stage\1"),
    _r(r"input_proj_(\d+)", r"model.input_proj_vision.\1.0"),
    _r(r"input_proj_norm_(\d+)", r"model.input_proj_vision.\1.1"),
    _r(r"text_backbone/(word_embeddings|position_embeddings|token_type_embeddings)",
       _TB + r".embeddings.\1"),
    _r(r"text_backbone/embed_norm", f"{_TB}.embeddings.LayerNorm"),
    _r(r"text_backbone/layer(\d+)/self/(query|key|value)",
       _TB + r".encoder.layer.\1.attention.self.\2"),
    _r(r"text_backbone/layer(\d+)/attn_out", _TB + r".encoder.layer.\1.attention.output.dense"),
    _r(r"text_backbone/layer(\d+)/attn_norm",
       _TB + r".encoder.layer.\1.attention.output.LayerNorm"),
    _r(r"text_backbone/layer(\d+)/(intermediate|output)", _TB + r".encoder.layer.\1.\2.dense"),
    _r(r"text_backbone/layer(\d+)/out_norm", _TB + r".encoder.layer.\1.output.LayerNorm"),
    _r(r"text_projection", "model.text_projection"),
    _r(r"level_embed", "model.level_embed"),
    _r(r"query_position_embeddings", "model.query_position_embeddings.weight"),
    _r(r"(enc_output|enc_output_norm)", r"model.\1"),
    _r(r"encoder_output_bbox_embed/layer(\d+)", r"model.encoder_output_bbox_embed.layers.\1"),
    _r(r"decoder_layer_norm", "model.decoder.layer_norm"),
    _r(r"reference_points_head/layer(\d+)", r"model.decoder.reference_points_head.layers.\1"),
    _r(r"decoder_bbox_embed/layer(\d+)", r"bbox_embed.0.layers.\1"),
    _r(r"encoder_layer(\d+)/(.+)",
       lambda m: f"model.encoder.layers.{m.group(1)}.{m.group(2).replace('/', '.')}"),
    _r(r"decoder_layer(\d+)/(.+)",
       lambda m: f"model.decoder.layers.{m.group(1)}.{m.group(2).replace('/', '.')}"),
]


def _gdino(module, draw):
    """GroundingDinoForObjectDetection's names, with the keys the converter
    drops: the Swin's relative position indices, BERT's position ids and the
    tied clones of the box head."""
    sd = synth(module, _GDINO_RULES, draw)
    c = module.cfg
    w = c.swin.window_size
    for s, depth in enumerate(c.swin.depths):
        for b in range(depth):
            sd[f"{_BB}.encoder.layers.{s}.blocks.{b}.attention.self.relative_position_index"] = \
                torch.zeros((w * w, w * w), dtype=torch.int64)
    sd[f"{_TB}.embeddings.position_ids"] = torch.arange(
        c.bert.max_position_embeddings, dtype=torch.int64)[None]
    for i in range(c.decoder_layers):
        for j in range(3):
            for p in ("weight", "bias"):
                src = sd[f"bbox_embed.0.layers.{j}.{p}"]
                if i:
                    sd[f"bbox_embed.{i}.layers.{j}.{p}"] = src
                sd[f"model.decoder.bbox_embed.{i}.layers.{j}.{p}"] = src
    return sd


_MD = "sam_mask_decoder"
_SAM2_RULES = [
    _r(r"no_mem_embed", "no_mem_embed"),
    _r(r"trunk/patch_embed", "image_encoder.trunk.patch_embed.proj"),
    _r(r"trunk/(pos_embed|pos_embed_window)", r"image_encoder.trunk.\1", "nchw"),
    _r(r"trunk/block(\d+)/(norm[12]|proj)", r"image_encoder.trunk.blocks.\1.\2"),
    _r(r"trunk/block(\d+)/attn/(qkv|proj)", r"image_encoder.trunk.blocks.\1.attn.\2"),
    _r(r"trunk/block(\d+)/mlp([12])",
       lambda m: f"image_encoder.trunk.blocks.{m.group(1)}.mlp.layers.{int(m.group(2)) - 1}"),
    _r(r"neck/conv(\d+)", r"image_encoder.neck.convs.\1.conv"),
    _r(r"prompt/pe_gaussian", "sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
    _r(r"prompt/point_embed_(\d)", r"sam_prompt_encoder.point_embeddings.\1.weight", "row"),
    _r(r"prompt/(not_a_point_embed|no_mask_embed)", r"sam_prompt_encoder.\1.weight", "row"),
    _r(r"decoder/(iou_token|mask_tokens|obj_score_token)", _MD + r".\1.weight"),
    _r(r"decoder/block(\d+)/mlp([12])", _MD + r".transformer.layers.\1.mlp.lin\2"),
    _r(r"decoder/block(\d+)/(.+)",
       lambda m: f"{_MD}.transformer.layers.{m.group(1)}.{m.group(2).replace('/', '.')}"),
    _r(r"decoder/final_attn_token_to_image/(\w+)",
       _MD + r".transformer.final_attn_token_to_image.\1"),
    _r(r"decoder/norm_final_attn", f"{_MD}.transformer.norm_final_attn"),
    _r(r"decoder/upscale([12])",
       lambda m: f"{_MD}.output_upscaling.{3 * (int(m.group(1)) - 1)}", "convt"),
    _r(r"decoder/upscale_norm", f"{_MD}.output_upscaling.1"),
    _r(r"decoder/(conv_s[01])", _MD + r".\1"),
    _r(r"decoder/hyper(\d+)_l(\d)", _MD + r".output_hypernetworks_mlps.\1.layers.\2"),
    _r(r"decoder/iou_l(\d)", _MD + r".iou_prediction_head.layers.\1"),
]


def _sam2(module, draw):
    """sam2.1's model: the image predictor's tensors and, beside them, video
    memory tensors the converter skips."""
    sd = synth(module, _SAM2_RULES, draw)
    sd["memory_attention.layers.0.self_attn.q_proj.weight"] = draw("skip.weight", (8, 8))
    sd["maskmem_tpos_enc"] = draw("skip.weight", (7, 1, 1, 64))
    return sd


_STATE_DICTS = {
    "hunyuan_dit": (lambda m, d: synth(m, _DIT_RULES, d)),
    "hunyuan_vae": (lambda m, d: synth(m, _VAE_RULES, d)),
    "hunyuan_cond": _hunyuan_cond, "moge": _moge, "hamer": _hamer, "vitpose": _vitpose,
    "flux_transformer": _flux_transformer, "flux_vae": _flux_vae, "flux_clip": _clip,
    "flux_t5": _t5, "yolov8_wilor": _yolov8, "hand_object_detector": _hand_object,
    "gdino": _gdino, "sam2": _sam2,
}


def state_dict(name: str, module, draw: Draw) -> Dict[str, Any]:
    """The reference checkpoint's state dict of the model whose parameter file
    is ``name`` (a key of the converters' outputs: ``hunyuan_dit``,
    ``hunyuan_vae``, ``hunyuan_cond``, ``moge``, ``hamer``, ``vitpose``,
    ``flux_transformer``, ``flux_vae``, ``flux_clip``, ``flux_t5``,
    ``yolov8_wilor``, ``hand_object_detector``, ``gdino``, ``sam2``), shaped
    for ``module`` (the port model, best on the meta device)."""
    return _STATE_DICTS[name](module, draw)
