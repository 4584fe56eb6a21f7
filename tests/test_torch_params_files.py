"""Converted parameter files in the PyTorch port: ``utils.params``' reader of
flax's serialized bytes, ``load_or_init`` and every stage build function that loads
a file where the JAX package loads it (Hunyuan's three models, MoGe, HaMeR,
FLUX.1-Kontext's four), against the JAX package on the same file.

Every file is written by the JAX package's own ``save_params`` into a
temporary ``FOHO_TPU_ASSETS``; the JAX side reads it back through its own
``load_or_init`` (the template is the saved tree, so no init runs). The
weights are ``test_torch_flux.random_params`` (``jax.eval_shape`` and numpy:
no init compile), so biases, norm scales and the random-init special cases
(the zero unconditional embedding, MoGe's zero scale readout, HaMeR's scaled
readout) all hold values that only the file can give.

Tolerances are those of each model's existing parity test (float32 on both
sides): the reader bit for bit; the DiT and the ShapeVAE 2e-5 absolute
(``test_torch_hunyuan``), the conditioner 2e-4 (``test_torch_conditioner``),
MoGe 1e-4 of each output's largest entry (``test_torch_moge``), HaMeR 2e-4 of
max(1, largest entry) (``test_torch_hamer``), FLUX's transformer 5e-5 and its
VAE 1e-5 of the largest entry (``test_torch_flux``), CLIP and T5 1e-5 of it
(``test_torch_text_towers``).
"""

import os
import warnings

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flux import random_params
from test_torch_hamer import _parity_configs
from test_torch_inpaint_stage import _configs as _flux_configs

import followmyhold_tpu.ops.attention  # noqa: F401  (imported before any jit traces it)
from followmyhold_tpu.models import clip_text as JC
from followmyhold_tpu.models import flux as JF
from followmyhold_tpu.models import hamer as JMH
from followmyhold_tpu.models import hunyuan as JH
from followmyhold_tpu.models import mano as JM
from followmyhold_tpu.models import moge as JMG
from followmyhold_tpu.models import t5 as JT5
from followmyhold_tpu.geometry import hunyuan as JGH
from followmyhold_tpu.geometry import moge as JGM
from followmyhold_tpu.utils import params as JP
from followmyhold_tpu_torch.configs import profiles as TPROF
from followmyhold_tpu_torch.geometry import hunyuan as TGH
from followmyhold_tpu_torch.geometry import moge as TGM
from followmyhold_tpu_torch.hand import hamer as THH
from followmyhold_tpu_torch.models import hamer as TMH
from followmyhold_tpu_torch.models import hunyuan as TH
from followmyhold_tpu_torch.models import mano as TM
from followmyhold_tpu_torch.preprocess import inpaint as TI
from followmyhold_tpu_torch.utils import params as TP


@pytest.fixture
def assets(tmp_path, monkeypatch):
    """An empty FOHO_TPU_ASSETS for this test."""
    root = tmp_path / "assets"
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(root))
    return root


def _save(name, params):
    """Write ``params`` with the JAX package's save_params; -> the tree the
    JAX package reads back from that file."""
    JP.save_params(name, params)
    return JP.load_or_init(name, lambda key: params)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ---- the reader ---------------------------------------------------------- #

def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return x


def _assert_same_tree(got, want):
    assert isinstance(got, dict) and sorted(got) == sorted(want)
    for key, w in want.items():
        if isinstance(w, dict):
            _assert_same_tree(got[key], w)
        elif isinstance(w, np.ndarray):
            g = got[key]
            assert isinstance(g, torch.Tensor) and tuple(g.shape) == w.shape, key
            if w.dtype.name == "bfloat16":
                assert g.dtype == torch.bfloat16
                np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
            else:
                assert str(g.dtype) == f"torch.{w.dtype.name}", key
                np.testing.assert_array_equal(g.numpy(), w)
        elif isinstance(w, np.generic):
            assert got[key].dim() == 0 and _as_numpy(got[key]) == w
        else:
            assert got[key] == w, key


def test_the_reader_gives_flax_s_tree(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"params": {
        "dense": {"kernel": rng.normal(size=(5, 3)).astype(np.float32),
                  "bias": np.zeros(3, np.float32)},
        "scale_bf16": jnp.asarray(rng.normal(size=(4, 2)), jnp.bfloat16),
        "ids": np.arange(7, dtype=np.int32), "steps": np.array([3, -9], np.int64),
        "mask": np.array([True, False]), "half": np.ones((2, 2), np.float16),
        "empty": np.zeros((0, 4), np.float32), "scalar": np.float32(0.25),
        "layers": [np.ones(3, np.float32), np.full((2,), 2.0, np.float32)]},
        "meta": {"name": "x" * 40, "count": 70_000, "neg": -3, "ratio": 0.5,
                 "flag": True, "none": None, "z": 1.5 - 2j}}
    path = str(tmp_path / "tree.msgpack")
    with open(path, "wb") as f:
        f.write(flax.serialization.to_bytes(tree))
    with open(path, "rb") as f:
        want = flax.serialization.msgpack_restore(f.read())
    got = TP.read_params_file(path)
    _assert_same_tree(got, want)
    assert sorted(got["params"]["layers"]) == ["0", "1"]   # a list is a map "0", "1"


def test_the_reader_joins_a_chunked_array(tmp_path, monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"w": rng.normal(size=(7, 9)).astype(np.float32),
            "b": jnp.asarray(rng.normal(size=(3, 40)), jnp.bfloat16),
            "small": np.arange(4, dtype=np.float32)}
    blob = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in blob
    path = str(tmp_path / "chunked.msgpack")
    with open(path, "wb") as f:
        f.write(blob)
    want = flax.serialization.msgpack_restore(blob)
    assert want["w"].shape == (7, 9)
    _assert_same_tree(TP.read_params_file(path), want)


@pytest.mark.parametrize("fault", ["shape", "missing", "unused", "no_tree"])
def test_a_file_that_does_not_fit_raises(assets, fault):
    model = JH.ShapeVAE(JH.VAE_TINY)
    params = random_params(lambda k: model.init(k, jnp.zeros((1, 16, 8)),
                                                jnp.zeros((1, 8, 3))), 3)
    inner = jax.tree_util.tree_map(np.asarray, params)["params"]
    if fault == "shape":
        inner["geo"]["logit"]["kernel"] = inner["geo"]["logit"]["kernel"][:-1]
        match = "geo/logit/kernel .*shape"
    elif fault == "missing":
        del inner["geo"]["logit"]["bias"]
        match = "geo.logit.bias"
    elif fault == "unused":
        inner["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
        match = "extra/kernel"
    if fault == "no_tree":
        os.makedirs(assets / "params")
        (assets / "params" / "hunyuan_vae.msgpack").write_bytes(b"x")
        match = "no parameter tree"
    else:
        JP.save_params("hunyuan_vae", {"params": inner})
    with pytest.raises(ValueError, match=match) as err:
        TP.load_or_init("hunyuan_vae", TH.ShapeVAE(TH.VAE_TINY), lambda m: None)
    assert "hunyuan_vae.msgpack" in str(err.value)


def test_load_or_init_draws_the_seeded_weights_without_a_file(assets):
    drawn = []
    module = TP.load_or_init("hunyuan_vae", TH.ShapeVAE(TH.VAE_TINY), drawn.append)
    assert drawn == [module]


# ---- the stage build functions ------------------------------------------ #

def test_hunyuan_build_models_loads_its_three_files(assets, monkeypatch):
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    vae_cfg, cond_cfg = JH.VAE_TINY, JH.COND_TINY
    dit = JH.HunyuanDiT(JH.DiTConfig(
        in_channels=vae_cfg.embed_dim, hidden=64, heads=4, depth_double=1, depth_single=1,
        context_dim=cond_cfg.embed_dim, time_dim=32, dtype=jnp.float32))
    vae, cond = JH.ShapeVAE(vae_cfg), JH.Conditioner(cond_cfg)
    lat0 = jnp.zeros((1, vae_cfg.num_latents, vae_cfg.embed_dim))
    dp = _save("hunyuan_dit", random_params(lambda k: dit.init(
        k, lat0, jnp.zeros(1), jnp.zeros((1, cond_cfg.n_tokens, cond_cfg.embed_dim))), 1))
    vp = _save("hunyuan_vae", random_params(lambda k: vae.init(k, lat0, jnp.zeros((1, 8, 3))),
                                            2))
    cp = _save("hunyuan_cond", random_params(lambda k: cond.init(
        k, jnp.zeros((1, cond_cfg.image_size, cond_cfg.image_size, 3))), 3))
    tdit, tvae, tcond = TGH.build_models(device="cpu")
    assert not any(p.requires_grad for m in (tdit, tvae, tcond) for p in m.parameters())
    assert torch.count_nonzero(tcond.uncond_embedding) > 0      # the file's, not zeroed

    rng = np.random.default_rng(4)
    lat = rng.normal(size=(2, vae_cfg.num_latents, vae_cfg.embed_dim)).astype(np.float32)
    ctx = rng.normal(size=(2, cond_cfg.n_tokens, cond_cfg.embed_dim)).astype(np.float32)
    t = np.array([0.15, 0.8], np.float32)
    pts = rng.uniform(-1.1, 1.1, (2, 40, 3)).astype(np.float32)
    rgba = rng.integers(0, 256, (40, 40, 4)).astype(np.uint8)
    with jax.default_matmul_precision("highest"):
        want_dit = jax.jit(dit.apply)(dp, lat, t, ctx)
        want_logits = jax.jit(vae.apply)(vp, lat, pts)
        want_tokens, want_uncond = JGH.encode_condition(cond, cp, rgba)
    with torch.no_grad():
        got_dit = tdit(_t(lat), _t(t), _t(ctx))
        got_logits = tvae(_t(lat), _t(pts))
    got_tokens, got_uncond = TGH.encode_condition(tcond, rgba, device="cpu")
    np.testing.assert_allclose(got_dit.numpy(), np.asarray(want_dit), atol=2e-5)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=2e-5)
    np.testing.assert_allclose(got_tokens.numpy(), np.asarray(want_tokens), atol=2e-4)
    np.testing.assert_array_equal(got_uncond.numpy(), np.asarray(want_uncond))


def test_moge_build_model_loads_its_file(assets, monkeypatch):
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    jmodel = JMG.MoGe(JGM._default_config())
    params = _save("moge", random_params(
        lambda k: jmodel.init(k, jnp.zeros((1, 70, 70, 3)), 25), 5))
    tmodel = TGM._build_model(TPROF.moge_config(), device="cpu")
    assert torch.count_nonzero(tmodel.scale_out.weight) > 0     # the file's, not zeroed
    img = np.random.default_rng(6).uniform(size=(1, 48, 64, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jmodel.apply, static_argnums=2)(params, jnp.asarray(img), 16)
    with torch.no_grad():
        got = tmodel(_t(img), 16)
    for name in ("points", "mask", "normal", "metric_scale"):
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_hamer_build_model_loads_its_file(assets):
    jcfg, tcfg = _parity_configs()
    jmodel = JMH.Hamer(jcfg)
    params = _save("hamer", random_params(
        lambda k: jmodel.init(k, jnp.zeros((1, 256, 256, 3))), 7))
    tmodel = THH._build_model(tcfg, device="cpu")
    want_w = np.asarray(params["params"]["mano_head"]["decpose"]["kernel"]).T
    np.testing.assert_array_equal(tmodel.mano_head.decpose.weight.numpy(), want_w)  # unscaled
    images = np.random.default_rng(8).normal(size=(2, 256, 256, 3)).astype(np.float32)
    mano = JM.synthetic_mano()
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, x: JMH.hamer_forward(jmodel, p, mano, x))(
            params, jnp.asarray(images))
    with torch.no_grad():
        got = TMH.hamer_forward(tmodel, TM.synthetic_mano(device="cpu"), _t(images))
    for name in TMH.HamerOutput._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=2e-4 * max(1.0, np.abs(w).max()), err_msg=name)


def test_learned_inpainter_loads_its_four_files(assets):
    (jf, jv, jc, jt), (tf, tv, tc, tt) = _flux_configs(JC.CLIP_TINY_TEST.eos_token_id)
    tr, vae = JF.FluxTransformer(jf), JF.FluxVae(jv)
    clip, t5 = JC.ClipTextModel(jc), JT5.T5Encoder(jt)
    n = 8
    inits = {
        "flux_transformer": lambda k: tr.init(
            k, jnp.zeros((1, n, jf.in_channels)), jnp.zeros((1, 4, jf.joint_dim)),
            jnp.zeros((1, jf.pooled_dim)), jnp.ones((1,)), jnp.zeros((n, 3)),
            jnp.zeros((4, 3)), jnp.ones((1,))),
        "flux_vae": lambda k: vae.init(k, jnp.zeros((1, 32, 32, 3))),
        "flux_clip": lambda k: clip.init(k, jnp.zeros((1, 8), jnp.int32)),
        "flux_t5": lambda k: t5.init(k, jnp.zeros((1, 9), jnp.int32)),
    }
    assert tuple(inits) == TI.FluxKontextInpainter.REQUIRED
    saved = {}
    for k, (name, init) in enumerate(inits.items()):
        # only some of the four files: the Telea fill, as in the reference
        assert TI._learned_inpainter("cpu", tf, tv, tc, tt) is None
        saved[name] = _save(name, random_params(init, 10 + k))
    port = TI._learned_inpainter("cpu", tf, tv, tc, tt)
    assert port is not None and port.device == torch.device("cpu")

    rng = np.random.default_rng(11)
    n_txt = 160
    hidden = rng.normal(size=(1, 128, jf.in_channels)).astype(np.float32)
    t5_states = rng.normal(size=(1, n_txt, jf.joint_dim)).astype(np.float32)
    pooled = rng.normal(size=(1, jf.pooled_dim)).astype(np.float32)
    img_ids = np.concatenate([JF.latent_ids(8, 8, 0), JF.latent_ids(8, 8, 1)])
    txt_ids = np.zeros((n_txt, 3), np.float32)
    t, g = np.asarray([0.7], np.float32), np.asarray([2.5], np.float32)
    want = jax.jit(tr.apply)(saved["flux_transformer"], hidden, t5_states, pooled, t, img_ids,
                             txt_ids, g)
    with torch.no_grad():
        got = port.transformer(_t(hidden), _t(t5_states), _t(pooled), _t(t), _t(img_ids),
                               _t(txt_ids), _t(g))
    _close(got.numpy(), want, 5e-5)

    x = rng.uniform(-1.0, 1.0, size=(1, 32, 32, 3)).astype(np.float32)
    want_z = jax.jit(lambda p, x: vae.apply(p, x, method=JF.FluxVae.encode))(
        saved["flux_vae"], x)
    want_x = jax.jit(lambda p, z: vae.apply(p, z, method=JF.FluxVae.decode))(
        saved["flux_vae"], want_z)
    with torch.no_grad():
        got_z = port.vae.encode(_t(x))
        got_x = port.vae.decode(_t(want_z))
    _close(got_z.numpy(), want_z, 1e-5)
    _close(got_x.numpy(), want_x, 1e-5)

    clip_ids = rng.integers(0, jc.vocab_size - 1, (1, 77))
    clip_ids[0, 20] = jc.eos_token_id
    t5_ids = rng.integers(0, 500, (1, 64))
    want_h, want_pooled = jax.jit(clip.apply)(saved["flux_clip"], jnp.asarray(clip_ids,
                                                                              jnp.int32))
    want_t5 = jax.jit(t5.apply)(saved["flux_t5"], jnp.asarray(t5_ids, jnp.int32))
    with torch.no_grad():
        got_h, got_pooled = port.clip(torch.from_numpy(clip_ids))
        got_t5 = port.t5(torch.from_numpy(t5_ids))
    _close(got_h.numpy(), want_h, 1e-5)
    _close(got_pooled.numpy(), want_pooled, 1e-5)
    _close(got_t5.numpy(), want_t5, 1e-5)


def test_the_f16_export_knob_is_ignored_with_one_warning(monkeypatch):
    vae = TP.init_random_(TH.ShapeVAE(TH.VAE_TINY), 4).eval()
    lat = torch.randn((1, TH.VAE_TINY.num_latents, TH.VAE_TINY.embed_dim),
                      generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        plain = TH.hierarchical_export_logits(vae, lat, 1.01, 16, chunk=512)
    monkeypatch.setenv("FOHO_EXPORT_F16", "1")
    monkeypatch.setattr(TH, "_EXPORT_F16_WARNED", False)
    with warnings.catch_warnings(record=True) as caught, torch.no_grad():
        warnings.simplefilter("always")
        grids = [TH.hierarchical_export_logits(vae, lat, 1.01, 16, chunk=512)
                 for _ in range(2)]
    said = [w for w in caught if "FOHO_EXPORT_F16" in str(w.message)]
    assert len(said) == 1 and "float32" in str(said[0].message)
    for grid in grids:
        assert grid.dtype == np.float32
        np.testing.assert_array_equal(grid, plain)
