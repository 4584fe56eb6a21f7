"""The checkpoint converters of the PyTorch port (``followmyhold_tpu_torch/
convert/``) against the JAX package's converters on the same state dicts.

Each of the converters' entry functions must give the JAX converter's tree:
the same keys in the same order at every level, the same shapes, dtypes and
bits, and the same mapped / missing / unused lists, for an exact-name state
dict and for one with a key dropped and a foreign key added. The one
difference is repaired on purpose: SAM2's two upscaling ConvTranspose kernels,
which the port flips in space as the JAX ViTPose converter does and the JAX
SAM2 converter does not (``test_sam2_upscaling_equals_torch_conv_transpose``).

The state dicts are tiny and drawn with numpy from a seed: the JAX package's
own synthesisers where its tests have one (the DiT, the ShapeVAE, the
conditioner in both namings, the generic ViT, ViTPose, FLUX's transformer and
VAE, SAM2), else ``followmyhold_tpu_torch/tools/_checkpoints.py`` (MoGe,
HaMeR, CLIP, T5, YOLOv8, the Faster R-CNN, GroundingDINO), whose names the
JAX converters must take whole.
The JAX converters' templates (``model.init``) are evaluated with
``jax.eval_shape`` and zero-filled for speed: a leaf the source lacks keeps
its template value, so only the missing-key cases see the difference, and
those compare the leaves that were converted (the port's missing leaves hold
``init_random_``'s values, checked against a module initialised with it).
"""

import contextlib
import dataclasses
import functools
import os
import re
import sys

import flax.linen
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_convert as JTC  # noqa: E402
import test_flux as JTF  # noqa: E402
import test_hunyuan_convert as JTH  # noqa: E402
import test_sam2 as JTS  # noqa: E402
import test_vitpose_convert as JTV  # noqa: E402

from followmyhold_tpu.convert.common import to_mutable  # noqa: E402
from followmyhold_tpu.convert import (  # noqa: E402
    flux as JCF, flux_text as JCT, gdino as JCG, hamer as JCH, hand_object as JCR,
    hunyuan as JCHY, moge as JCM, sam2 as JCS, vit_torch as JCVT, vitpose as JCVP,
    yolov8 as JCY)
from followmyhold_tpu.models import (  # noqa: E402
    clip_text as JMC, flux as JMF, gdino as JMG, hamer as JMH, hand_object_detector as JMR,
    hunyuan as JMHY, moge as JMM, sam2 as JMS, t5 as JMT, vit as JMV, vitpose as JMVP,
    yolov8 as JMY)
from followmyhold_tpu_torch.convert import (  # noqa: E402
    flux as TCF, flux_text as TCT, gdino as TCG, hamer as TCH, hand_object as TCR,
    hunyuan as TCHY, moge as TCM, sam2 as TCS, vit_torch as TCVT, vitpose as TCVP,
    yolov8 as TCY)
from followmyhold_tpu_torch.convert.common import filled  # noqa: E402
from followmyhold_tpu_torch.tools import _checkpoints as CK  # noqa: E402
from followmyhold_tpu_torch.models import (  # noqa: E402
    clip_text as TMC, flux as TMF, gdino as TMG, hamer as TMH, hand_object_detector as TMR,
    hunyuan as TMHY, moge as TMM, sam2 as TMS, t5 as TMT, vit as TMV, vitpose as TMVP,
    yolov8 as TMY)
from followmyhold_tpu_torch.utils import params as TP  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
           jnp.float16: torch.float16}


def np_draw(rng):
    """Values for ``tools._checkpoints``: N(0, 0.05^2) float32, a BatchNorm's
    variance in [0.5, 1.5) and its counter an int64."""
    def draw(name, shape):
        if name.endswith("num_batches_tracked"):
            return np.asarray(100, np.int64)
        if name.endswith("running_var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.05, shape).astype(np.float32)

    return draw


@contextlib.contextmanager
def module_rng(module, rng):
    """A JAX test module's synthesisers drawing from ``rng`` (its ``RNG``
    restored afterwards)."""
    saved = module.RNG
    module.RNG = rng
    try:
        yield
    finally:
        module.RNG = saved


def port_cfg(jcfg, tcls):
    """The port's configuration of the same values as the JAX ``jcfg``."""
    out = {}
    defaults = tcls()
    for f in dataclasses.fields(tcls):
        if not hasattr(jcfg, f.name):
            continue
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = port_cfg(v, type(getattr(defaults, f.name)))
        elif f.name == "dtype":
            v = _DTYPES[v]
        out[f.name] = v
    return tcls(**out)


_SHAPES = {}     # (module class, configuration) -> the shapes of its init


@contextlib.contextmanager
def shape_only_init(seen=None):
    """Flax ``Module.init`` as ``jax.eval_shape`` of itself (traced once a
    module class and configuration), zero-filled; each call's shapes are
    appended to ``seen``."""
    orig = flax.linen.Module.init

    def init(self, rngs, *args, **kwargs):
        key = (type(self), repr(getattr(self, "cfg", self)))
        if key not in _SHAPES:
            _SHAPES[key] = jax.eval_shape(lambda k: orig(self, k, *args, **kwargs), rngs)
        shapes = _SHAPES[key]
        if seen is not None:
            seen.append(shapes)
        return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    flax.linen.Module.init = init
    try:
        yield
    finally:
        flax.linen.Module.init = orig


# ---- the cases: (JAX convert, port convert, state dict, port model) -------- #

_TINY_VIT = dict(img_size=(28, 28), patch_size=14, embed_dim=32, depth=2, num_heads=2,
                 use_cls_token=True, layerscale_init=1e-5)
_MOGE = dict(intermediate_layers=(0, 1), dim_proj=16, neck_dims=(16, 16, 8),
             head_dims=(16, 16, 8), num_res_blocks=1, scale_head_dims=(16, 1),
             num_tokens_range=(4, 16))
_HAMER = dict(head_dim=32, head_depth=2, head_heads=2, head_dim_head=8, head_mlp_dim=32,
              context_dim=32, image_size=64)


@dataclasses.dataclass
class Case:
    jax_fn: object      # sd -> (tree, report)
    port_fn: object     # sd -> (tree, report)
    sd: dict
    model: object       # () -> the port module on the CPU (for init_random_)
    drop: str           # a key whose absence each converter reports


def _vit_case(rng):
    jcfg = JTC.TINY_VIT
    tcfg = port_cfg(jcfg, TMV.ViTConfig)
    jmodel = JMV.ViT(jcfg)

    def jax_fn(sd):
        params = to_mutable(jmodel.init(jax.random.key(0),
                                                     jnp.zeros((1, 32, 32, 3))))
        return params, JCVT.convert_vit(sd, params)

    def port_fn(sd):
        model = TMV.ViT(tcfg, device="meta")
        params = TP.torch_to_flax(model)
        report = TCVT.convert_vit(sd, params)
        return filled(params, model), report

    return Case(jax_fn, port_fn, JTC.synth_vit_torch_sd(jcfg, rng),
                lambda: TMV.ViT(tcfg, device="cpu"), "blocks.1.attn.proj.weight")


def _hunyuan_case(kind, rng):
    if kind == "dit":
        jcfg, tcfg = JMHY.DIT_TINY, TMHY.DIT_TINY
        with module_rng(JTH, rng):
            sd = JTH._synth_dit_sd(jcfg)
        return Case(lambda sd: JCHY.convert_dit(sd, jcfg), lambda sd: TCHY.convert_dit(sd, tcfg),
                    sd, lambda: TMHY.HunyuanDiT(tcfg, device="cpu"),
                    "single_blocks.1.linear2.weight")
    if kind == "vae":
        jcfg, tcfg = JMHY.VAE_TINY, TMHY.VAE_TINY
        with module_rng(JTH, rng):
            sd = JTH._synth_vae_sd(jcfg)
        return Case(lambda sd: JCHY.convert_vae(sd, jcfg), lambda sd: TCHY.convert_vae(sd, tcfg),
                    sd, lambda: TMHY.ShapeVAE(tcfg, device="cpu"),
                    "geo_decoder.cross_attn_decoder.attn.c_kv.bias")
    naming, ffn = kind.split("_")[1:]
    jcfg = JMHY.COND_TINY if ffn == "mlp" else JTH.COND_TINY_SWIGLU
    tcfg = port_cfg(jcfg, TMHY.ConditionerConfig)
    synth = JTH._synth_cond_timm if naming == "timm" else JTH._synth_cond_hf
    pfx = "main_image_encoder.model."
    drop = pfx + ("blocks.0.norm2.weight" if naming == "timm"
                  else "encoder.layer.0.attention.attention.key.bias")
    with module_rng(JTH, rng):
        sd = synth(jcfg)
    return Case(lambda sd: JCHY.convert_conditioner(sd, jcfg),
                lambda sd: TCHY.convert_conditioner(sd, tcfg), sd,
                lambda: TMHY.Conditioner(tcfg, device="cpu"), drop)


def _moge_case(rng):
    jcfg = JMM.MoGeConfig(encoder=JMV.ViTConfig(dtype=jnp.float32, **_TINY_VIT),
                          dtype=jnp.float32, **_MOGE)
    tcfg = port_cfg(jcfg, TMM.MoGeConfig)
    return Case(lambda sd: JCM.convert_moge(sd, jcfg), lambda sd: TCM.convert_moge(sd, tcfg),
                CK.state_dict("moge", TMM.MoGe(tcfg, device="meta"), np_draw(rng)),
                lambda: TMM.MoGe(tcfg, device="cpu"),
                "neck.res_blocks.1.0.layers.0.weight")


def _hamer_case(rng):
    jcfg = JMH.HamerConfig(backbone=JMV.ViTConfig(
        img_size=(64, 48), patch_size=16, embed_dim=32, depth=2, num_heads=2, patch_padding=2,
        pos_embed_cls_slot=True, dtype=jnp.float32), dtype=jnp.float32, **_HAMER)
    tcfg = port_cfg(jcfg, TMH.HamerConfig)
    return Case(lambda sd: JCH.convert_hamer(sd, jcfg), lambda sd: TCH.convert_hamer(sd, tcfg),
                CK.state_dict("hamer", TMH.Hamer(tcfg, device="meta"), np_draw(rng)),
                lambda: TMH.Hamer(tcfg, device="cpu"),
                "mano_head.transformer.transformer.layers.1.1.fn.to_kv.weight")


def _vitpose_case(rng):
    jcfg, tcfg = JMVP.VITPOSE_TINY, TMVP.VITPOSE_TINY
    with module_rng(JTV, rng):
        sd = JTV._synth_vitpose_sd(jcfg)
    return Case(lambda sd: JCVP.convert_vitpose(sd, jcfg),
                lambda sd: TCVP.convert_vitpose(sd, tcfg), sd,
                lambda: TMVP.ViTPose(tcfg, device="cpu"),
                "keypoint_head.deconv_layers.3.weight")


def _flux_case(kind, rng):
    if kind == "flux_transformer":
        jcfg, tcfg = JMF.FLUX_TINY_TEST, TMF.FLUX_TINY_TEST
        with module_rng(JTF, rng):
            sd = JTF._synth_diffusers_transformer(jcfg)
        return Case(lambda sd: JCF.convert_flux_transformer(sd, jcfg),
                    lambda sd: TCF.convert_flux_transformer(sd, tcfg), sd,
                    lambda: TMF.FluxTransformer(tcfg, device="cpu"),
                    "transformer_blocks.0.attn.norm_added_k.weight")
    jcfg, tcfg = JMF.FLUX_VAE_TINY, TMF.FLUX_VAE_TINY
    with module_rng(JTF, rng):
        sd = JTF._synth_diffusers_vae(jcfg)
    return Case(lambda sd: JCF.convert_flux_vae(sd, jcfg),
                lambda sd: TCF.convert_flux_vae(sd, tcfg), sd, lambda: TMF.FluxVae(tcfg, device="cpu"),
                "decoder.up_blocks.1.resnets.0.conv_shortcut.weight")


def _text_case(kind, rng):
    if kind == "clip":
        jcfg, tcfg = JMC.CLIP_TINY_TEST, TMC.CLIP_TINY_TEST
        return Case(lambda sd: JCT.convert_clip_text(sd, jcfg),
                    lambda sd: TCT.convert_clip_text(sd, tcfg),
                    CK.state_dict("flux_clip", TMC.ClipTextModel(tcfg, device="meta"),
                                  np_draw(rng)),
                    lambda: TMC.ClipTextModel(tcfg, device="cpu"),
                    "text_model.encoder.layers.1.layer_norm2.bias")
    jcfg, tcfg = JMT.T5_TINY_TEST, TMT.T5_TINY_TEST
    return Case(lambda sd: JCT.convert_t5_encoder(sd, jcfg),
                lambda sd: TCT.convert_t5_encoder(sd, tcfg),
                CK.state_dict("flux_t5", TMT.T5Encoder(tcfg, device="meta"), np_draw(rng)),
                lambda: TMT.T5Encoder(tcfg, device="cpu"),
                "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight")


def _detector_case(kind, rng):
    if kind == "yolov8":
        jcfg, tcfg = JMY.YOLOV8_TINY_TEST, TMY.YOLOV8_TINY_TEST
        return Case(lambda sd: JCY.convert_yolov8(sd, jcfg),
                    lambda sd: TCY.convert_yolov8(sd, tcfg),
                    CK.state_dict("yolov8_wilor", TMY.YoloV8(tcfg, device="meta"), np_draw(rng)),
                    lambda: TMY.YoloV8(tcfg, device="cpu"), "model.22.cv3.1.2.bias")
    if kind == "hand_object":
        jcfg, tcfg = JMR.FRCNN_TINY, TMR.FRCNN_TINY
        return Case(lambda sd: JCR.convert_hand_object(sd, jcfg),
                    lambda sd: TCR.convert_hand_object(sd, tcfg),
                    CK.state_dict("hand_object_detector",
                                  TMR.HandObjectDetector(tcfg, device="meta"), np_draw(rng)),
                    lambda: TMR.HandObjectDetector(tcfg, device="cpu"), "RCNN_top.0.0.conv2.weight")
    if kind == "gdino":
        jcfg, tcfg = JMG.GDINO_TINY, TMG.GDINO_TINY
        return Case(lambda sd: JCG.convert_gdino(sd, jcfg), lambda sd: TCG.convert_gdino(sd, tcfg),
                    CK.state_dict("gdino", TMG.GroundingDino(tcfg, device="meta"), np_draw(rng)),
                    lambda: TMG.GroundingDino(tcfg, device="cpu"),
                    "model.encoder.layers.0.fusion_layer.text_param")
    jcfg, tcfg = JMS.SAM2_TINY_TEST, TMS.SAM2_TINY_TEST
    return Case(lambda sd: JCS.convert_sam2(sd, jcfg), lambda sd: TCS.convert_sam2(sd, tcfg),
                JTS._synth_sam2_sd(jcfg, rng), lambda: TMS.Sam2(tcfg, device="cpu"),
                "sam_mask_decoder.output_upscaling.1.bias")


CASES = ["vit", "dit", "vae", "cond_timm_mlp", "cond_hf_mlp", "cond_timm_swiglu",
         "cond_hf_swiglu", "moge", "hamer", "vitpose", "flux_transformer", "flux_vae", "clip",
         "t5", "yolov8", "hand_object", "gdino", "sam2"]


@functools.lru_cache(maxsize=None)
def case(name: str) -> Case:
    rng = np.random.default_rng(CASES.index(name) + 100)
    if name == "vit":
        return _vit_case(rng)
    if name in ("dit", "vae") or name.startswith("cond"):
        return _hunyuan_case(name, rng)
    if name.startswith("flux"):
        return _flux_case(name, rng)
    if name in ("clip", "t5"):
        return _text_case(name, rng)
    if name in ("yolov8", "hand_object", "gdino", "sam2"):
        return _detector_case(name, rng)
    return {"moge": _moge_case, "hamer": _hamer_case, "vitpose": _vitpose_case}[name](rng)


def run_jax(c: Case, sd, seen=None):
    with shape_only_init(seen), jax.default_device(jax.devices("cpu")[0]):
        return c.jax_fn(dict(sd))


_INIT_SHAPES = {}


@functools.lru_cache(maxsize=None)
def converted(name: str):
    """(JAX tree, JAX report, port tree, port report) on the whole dict; the
    shapes of the JAX converter's ``model.init`` go to ``_INIT_SHAPES``."""
    c = case(name)
    seen = []
    jp, jr = run_jax(c, c.sd, seen)
    _INIT_SHAPES[name] = seen[0]
    tp, tr = c.port_fn(dict(c.sd))
    return jp, jr, tp, tr


# ---- tree comparisons ----------------------------------------------------- #

def leaves(tree, pre=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, pre + (k,)))
        else:
            out[pre + (k,)] = v
    return out


def assert_same_keys(jtree, ttree, pre=()):
    """The same keys in the same order at every level."""
    assert list(jtree) == list(ttree), (pre, list(jtree)[:6], list(ttree)[:6])
    for k, v in jtree.items():
        if isinstance(v, dict):
            assert isinstance(ttree[k], dict), pre + (k,)
            assert_same_keys(v, ttree[k], pre + (k,))


def as_numpy(v) -> np.ndarray:
    assert isinstance(v, torch.Tensor) and v.device.type == "cpu", type(v)
    return v.numpy()


def assert_same_leaf(j, t, where):
    j, t = np.asarray(j), as_numpy(t)
    assert j.shape == t.shape and j.dtype == t.dtype, (where, j.shape, t.shape, j.dtype, t.dtype)
    assert j.tobytes() == t.tobytes(), where


_SAM2_FLIPPED = {("params", "decoder", "upscale1", "kernel"),
                 ("params", "decoder", "upscale2", "kernel")}


def assert_port_tree(name, jp, tp, report):
    """The port's tree against the JAX converter's: the same keys; every
    converted leaf the same bits (SAM2's upscaling kernels flipped); every
    leaf the source lacks ``init_random_``'s value."""
    assert_same_keys(jp, tp)
    jl, tl = leaves(jp), leaves(tp)
    mapped = {tuple(["params"] + m.split("/")[1:]) for m in report.mapped}
    fresh = None
    for path, t in tl.items():
        if path in mapped:
            j = np.asarray(jl[path])
            if name == "sam2" and path in _SAM2_FLIPPED:
                j = j[::-1, ::-1]      # the repaired fault
            assert_same_leaf(j, t, path)
        else:
            if fresh is None:
                fresh = leaves(TP.torch_to_flax(TP.init_random_(case(name).model(), 0)))
            assert torch.equal(t, fresh[path]), path
    return set(tl) - mapped


@pytest.mark.parametrize("name", CASES)
def test_converter_gives_the_jax_tree(name):
    jp, jr, tp, tr = converted(name)
    assert tr.missing_src == [] and tr.unused_src == [], (tr.missing_src[:5], tr.unused_src[:5])
    assert (jr.mapped, jr.missing_src, jr.unused_src) == (tr.mapped, tr.missing_src, tr.unused_src)
    unmapped = assert_port_tree(name, jp, tp, tr)
    # ViTPose's deconvolutions have no bias in the checkpoint: both keep a zero one
    assert unmapped == ({("params", f"deconv{i}", "bias") for i in range(2)}
                        if name == "vitpose" else set())


@pytest.mark.parametrize("name", CASES)
def test_converter_reports_a_missing_and_a_foreign_key(name):
    c = case(name)
    assert c.drop in c.sd
    sd = {k: v for k, v in c.sd.items() if k != c.drop}
    sd["foreign.layer.extra"] = np.ones((2, 3), np.float32)
    jp, jr = run_jax(c, sd)
    tp, tr = c.port_fn(dict(sd))
    # YOLOv8's converter walks the source's modules, so it lists nothing
    # missing (as the reference's does); the dropped bias keeps its fill
    assert (c.drop in tr.missing_src) != (name == "yolov8")
    assert (jr.mapped, jr.missing_src, jr.unused_src) == (tr.mapped, tr.missing_src, tr.unused_src)
    assert len(assert_port_tree(name, jp, tp, tr)) > (2 if name == "vitpose" else 0)


# the synthetic checkpoints chip_smoke.py converts at full width, by the JAX converters
_SYNTH = {"hunyuan_dit": "dit", "hunyuan_vae": "vae", "hunyuan_cond": "cond_timm_mlp",
          "vitpose": "vitpose", "flux_transformer": "flux_transformer", "flux_vae": "flux_vae",
          "sam2": "sam2"}


@pytest.mark.parametrize("name", sorted(_SYNTH))
def test_synthetic_checkpoint_has_the_reference_s_names(name):
    """``tools._checkpoints``' state dicts, which ``chip_smoke.py`` converts at full
    width, convert whole in the JAX package too (the names its tests do not draw)."""
    c = case(_SYNTH[name])
    sd = CK.state_dict(name, c.model().to("meta"), np_draw(np.random.default_rng(7)))
    jp, jr = run_jax(c, sd)
    assert jr.missing_src == [] and jr.unused_src == [], (jr.missing_src[:4], jr.unused_src[:4])
    tp, tr = c.port_fn(sd)
    assert (jr.mapped, tr.missing_src, tr.unused_src) == (tr.mapped, [], [])
    assert_port_tree(_SYNTH[name], jp, tp, tr)


# ---- the template and the bridge ------------------------------------------ #

@pytest.mark.parametrize("name", [n for n in CASES if n not in ("cond_hf_mlp", "cond_hf_swiglu")])
def test_template_has_the_structure_of_the_jax_init(name):
    converted(name)
    want = _INIT_SHAPES[name]          # the JAX converter's model.init, evaluated for shapes
    got = TP.torch_to_flax(case(name).model().to("meta"))
    assert_same_keys(want, got)
    for path, w in leaves(want).items():
        g = leaves(got)[path]
        assert tuple(w.shape) == tuple(g.shape), path
        assert str(w.dtype) == "float32" and g.dtype == torch.float32, path


@pytest.mark.parametrize("name", ["dit", "cond_timm_mlp", "moge", "hamer", "vitpose",
                                  "flux_transformer", "t5", "hand_object", "gdino", "sam2"])
def test_torch_to_flax_is_the_inverse_of_flax_to_torch(name):
    c = case(name)
    m = TP.init_random_(c.model(), 1)
    with torch.no_grad():
        for p in m.parameters():        # every value distinct, biases and scales too
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    m2 = TP.init_random_(c.model(), 2)
    TP.flax_to_torch(TP.torch_to_flax(m), m2)
    want, got = m.state_dict(), m2.state_dict()
    assert list(want) == list(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k


# ---- the writer ------------------------------------------------------------ #

@pytest.fixture
def assets(tmp_path, monkeypatch):
    root = tmp_path / "assets"
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(root))
    return root


def _mixed_tree(rng):
    return {"params": {
        "zeta": {"kernel": rng.normal(size=(5, 3)).astype(np.float32),
                 "bias": np.zeros(3, np.float32)},
        "alpha": np.asarray(jnp.asarray(rng.normal(size=(4, 2)), jnp.bfloat16)),
        "ids": np.arange(300, dtype=np.int32), "mask": np.array([True, False]),
        "half": np.ones((2, 2), np.float16), "empty": np.zeros((0, 4), np.float32),
        "scalar": np.float32(0.25), "zero_d": np.array(7, np.int64),
        "wide": rng.normal(size=(70000,)),
        "t": rng.normal(size=(3, 4)).astype(np.float32).T,       # not contiguous
    }, "meta": {"step": 3, "neg": -70000, "big": 2 ** 40, "name": "x" * 40,
                "count": np.int64(7), "many": {str(i): i for i in range(20)}}}


def test_save_params_writes_flax_s_bytes(assets):
    rng = np.random.default_rng(0)
    tree = _mixed_tree(rng)
    want = flax.serialization.to_bytes(tree)
    path = TP.save_params("mixed", tree)
    assert path == TP.params_path("mixed")
    with open(path, "rb") as f:
        assert f.read() == want
    # tensors: the same bytes as the numpy arrays of their values
    arrays = tree["params"]
    tensors = {"zeta": {k: torch.from_numpy(v) for k, v in arrays["zeta"].items()},
               "alpha": torch.from_numpy(arrays["alpha"].view(np.int16).copy()).view(
                   torch.bfloat16),
               "ids": torch.from_numpy(arrays["ids"]), "mask": torch.from_numpy(arrays["mask"]),
               "t": torch.from_numpy(arrays["t"])}
    TP.save_params("tensors", tensors)
    with open(TP.params_path("tensors"), "rb") as f:
        assert f.read() == flax.serialization.to_bytes(
            {k: arrays[k] for k in ("zeta", "alpha", "ids", "mask", "t")})


@pytest.mark.parametrize("leaf", [1.5, None, True, [1, 2], b"raw"],
                         ids=["float", "none", "bool", "list", "bytes"])
def test_save_params_refuses_what_no_converter_writes(assets, leaf):
    with pytest.raises(TypeError, match="cannot write"):
        TP.save_params("refused", {"params": {"x": np.zeros(2, np.float32)}, "meta": leaf})
    assert not os.path.exists(TP.params_path("refused"))


def test_save_params_chunks_a_large_array_as_flax_does(assets, monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(TP, "MAX_CHUNK_SIZE", 1000)
    rng = np.random.default_rng(1)
    big = rng.normal(size=(7, 100)).astype(np.float32)        # 2800 bytes: three chunks
    odd = rng.normal(size=(3, 37)).astype(np.float16)         # 222 bytes: one piece
    tree = {"params": {"block": {"kernel": big, "bias": odd},
                       "exact": np.arange(250, dtype=np.float32)}}    # 1000 bytes: whole
    want = flax.serialization.to_bytes(tree)
    TP.save_params("chunked", {"params": {"block": {"kernel": torch.from_numpy(big),
                                                    "bias": torch.from_numpy(odd)},
                                          "exact": torch.arange(250, dtype=torch.float32)}})
    with open(TP.params_path("chunked"), "rb") as f:
        got = f.read()
    assert got == want and b"__msgpack_chunked_array__" in got
    back = TP.read_params_file(TP.params_path("chunked"))
    assert torch.equal(back["params"]["block"]["kernel"], torch.from_numpy(big))
    restored = flax.serialization.msgpack_restore(got)
    np.testing.assert_array_equal(restored["params"]["block"]["kernel"], big)


def test_a_port_converted_file_loads_in_both_packages(assets):
    from followmyhold_tpu.utils import params as JP

    jp, _, tp, _ = converted("vitpose")
    path = TP.save_params("vitpose", tp)
    with open(path, "rb") as f:
        raw = f.read()
    assert raw == flax.serialization.to_bytes(jp)            # byte for byte the JAX file
    restored = flax.serialization.msgpack_restore(raw)
    assert_same_keys(restored, tp)
    for p, v in leaves(tp).items():
        assert_same_leaf(leaves(restored)[p], v, p)
        assert torch.equal(leaves(TP.read_params_file(path))[p], v)
    got = JP.load_or_init("vitpose", lambda key: jp)
    for p, v in leaves(tp).items():
        assert_same_leaf(leaves(got)[p], v, p)
    model = TP.load_params("vitpose", TMVP.ViTPose(TMVP.VITPOSE_TINY, device="cpu"))
    want = TP.flax_to_torch(tp, TMVP.ViTPose(TMVP.VITPOSE_TINY, device="cpu"))
    for (k, a), b in zip(model.state_dict().items(), want.state_dict().values()):
        assert torch.equal(a, b), k


# ---- the two reference faults, repaired ----------------------------------- #

def test_sam2_upscaling_equals_torch_conv_transpose():
    c = case("sam2")
    jp, _, tp, _ = converted("sam2")
    rng = np.random.default_rng(3)
    d = TMS.SAM2_TINY_TEST.d_model
    x = torch.from_numpy(rng.normal(size=(1, d, 5, 6)).astype(np.float32))
    w = torch.from_numpy(c.sd["sam_mask_decoder.output_upscaling.0.weight"])
    b = torch.from_numpy(c.sd["sam_mask_decoder.output_upscaling.0.bias"])
    want = torch.nn.functional.conv_transpose2d(x, w, b, stride=2)

    def upscale(tree):
        model = TP.flax_to_torch(tree, TMS.Sam2(TMS.SAM2_TINY_TEST, device="cpu"))
        with torch.no_grad():
            return model.decoder.upscale1(x)

    assert (upscale(tp) - want).abs().max() <= 1e-5
    jax_tree = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    assert (upscale(jax_tree) - want).abs().max() > 1e-2   # the JAX converter's mirror
    # the JAX model's ConvTranspose on the port's kernel computes the same
    layer = flax.linen.ConvTranspose(d // 4, (2, 2), strides=(2, 2))
    k = tp["params"]["decoder"]["upscale1"]
    y = layer.apply({"params": {"kernel": k["kernel"].numpy(), "bias": k["bias"].numpy()}},
                    x.permute(0, 2, 3, 1).numpy())
    np.testing.assert_allclose(np.asarray(y).transpose(0, 3, 1, 2), want.numpy(), atol=1e-5)


def _hunyuan_checkpoint(tmp_path, rng):
    t = lambda sd: {k: torch.from_numpy(v).half() for k, v in sd.items()}   # noqa: E731
    with module_rng(JTH, rng):
        ckpt = {"model": t(JTH._synth_dit_sd(JMHY.DIT_TINY)),
                "vae": t(JTH._synth_vae_sd(JMHY.VAE_TINY)),
                "conditioner": t(JTH._synth_cond_hf(JMHY.COND_TINY))}
    path = tmp_path / "model.ckpt"
    torch.save(ckpt, path)
    return str(path), ckpt


def test_hunyuan_main_writes_hunyuan_cond_and_build_models_loads_it(assets, tmp_path,
                                                                   monkeypatch, capsys):
    from followmyhold_tpu_torch.geometry import hunyuan as TGH

    path, ckpt = _hunyuan_checkpoint(tmp_path, np.random.default_rng(5))
    cfgs = dict(dit_cfg=TMHY.DIT_TINY, vae_cfg=TMHY.VAE_TINY, cond_cfg=TMHY.COND_TINY)
    monkeypatch.setattr(TCHY, "DiTConfig", lambda: cfgs["dit_cfg"])
    monkeypatch.setattr(TCHY, "ShapeVAEConfig", lambda: cfgs["vae_cfg"])
    monkeypatch.setattr(TCHY, "ConditionerConfig", lambda: cfgs["cond_cfg"])
    sched = tmp_path / "scheduler.json"
    sched.write_text('{"scheduler": {"params": {"shift": 3.0, "name": "flow"}}}')
    TCHY.main(["--ckpt", path, "--scheduler_config", str(sched)])
    out = capsys.readouterr().out
    for part in ("dit", "vae", "conditioner"):
        assert re.search(rf"^{part}: mapped \d+ tensors; 0 missing, 0 unused$", out, re.M), out
    names = sorted(os.listdir(assets / "params"))
    assert names == ["hunyuan_cond.msgpack", "hunyuan_dit.msgpack", "hunyuan_scheduler.json",
                     "hunyuan_vae.msgpack"]
    assert TP.scheduler_config() == {"shift": 3.0, "name": "flow"}
    dit, vae, cond = TGH.build_models(**cfgs, device="cpu")
    for model, fn, key in ((dit, TCHY.convert_dit, "model"), (vae, TCHY.convert_vae, "vae"),
                           (cond, TCHY.convert_conditioner, "conditioner")):
        tree, _ = fn(ckpt[key], cfgs[{"model": "dit_cfg", "vae": "vae_cfg",
                                      "conditioner": "cond_cfg"}[key]])
        want = TP.flax_to_torch(tree, type(model)(model.cfg, device="cpu"))
        for (k, a), b in zip(model.state_dict().items(), want.state_dict().values()):
            assert torch.equal(a, b), (key, k)
    assert cond.uncond_embedding.abs().max() > 0      # the file's, not the random init's zeros


def test_hunyuan_main_reads_yaml_only_where_yaml_imports(assets, tmp_path, monkeypatch, capsys):
    path, _ = _hunyuan_checkpoint(tmp_path, np.random.default_rng(6))
    for name, cfg in (("DiTConfig", TMHY.DIT_TINY), ("ShapeVAEConfig", TMHY.VAE_TINY),
                      ("ConditionerConfig", TMHY.COND_TINY)):
        monkeypatch.setattr(TCHY, name, lambda cfg=cfg: cfg)
    sched = tmp_path / "config.yaml"
    sched.write_text("scheduler:\n  params:\n    shift: 2.5\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(SystemExit):
        TCHY.main(["--ckpt", path, "--scheduler_config", str(sched)])
    assert "yaml module, which is not installed" in capsys.readouterr().err
    monkeypatch.delitem(sys.modules, "yaml")
    TCHY.main(["--ckpt", path, "--scheduler_config", str(sched)])
    assert TP.scheduler_config() == {"shift": 2.5}


# ---- the command lines ---------------------------------------------------- #

_CLIS = ["hunyuan", "moge", "hamer", "vitpose", "flux", "flux_text", "yolov8", "hand_object",
         "gdino", "sam2"]


def _flags(main, argv_param, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["convert", "--help"])
    with pytest.raises(SystemExit):
        main(["--help"]) if argv_param else main()
    return sorted(set(re.findall(r"--\w+", capsys.readouterr().out)))


@pytest.mark.parametrize("name", _CLIS)
def test_command_line_takes_the_jax_converter_s_flags(name, monkeypatch, capsys):
    import importlib

    jmod = importlib.import_module(f"followmyhold_tpu.convert.{name}")
    tmod = importlib.import_module(f"followmyhold_tpu_torch.convert.{name}")
    assert _flags(tmod.main, True, monkeypatch, capsys) == _flags(jmod.main, False, monkeypatch,
                                                                  capsys)
