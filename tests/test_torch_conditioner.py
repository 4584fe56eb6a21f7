"""The image conditioner of the PyTorch port against the JAX package: the cubic
resize, the DINOv2 ViT and ``encode_condition``, with the same weights
(through ``flax_to_torch``) and the same numpy inputs.

Tolerances, float32 on both sides:
- the resize: 5e-5 absolute on unit-normal images (4 taps a sample; the weight
  matrices agree to one float32 ulp, the contractions sum in another order:
  measured 1.4e-5 at 512 -> 518);
- the ViT and the conditioner: 2e-4 absolute on LayerNorm-ed tokens of order
  one (two blocks; measured about 1e-5), as the DiT's 2e-5 through fewer,
  narrower layers, widened for the resize and the patch convolution in front.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followmyhold_tpu.geometry import hunyuan as JGH
from followmyhold_tpu.models import hunyuan as JH
from followmyhold_tpu.models import vit as JV
from followmyhold_tpu_torch.geometry import hunyuan as TGH
from followmyhold_tpu_torch.models import hunyuan as TH
from followmyhold_tpu_torch.models import vit as TV
from followmyhold_tpu_torch.ops.image import resize_cubic
from followmyhold_tpu_torch.utils.params import flax_to_torch

ATOL = 2e-4


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(scale=0.05, size=x.shape).astype(np.float32),
        params)


@pytest.mark.parametrize("src,dst", [((64, 64), (70, 70)), ((96, 80), (28, 28)),
                                     ((37, 50), (23, 61))],
                         ids=["upsample", "downsample", "mixed"])
def test_cubic_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(0).normal(size=(2, *src, 4)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.image.resize(jnp.asarray(x), (2, *dst, 4), "cubic")
    got = resize_cubic(torch.from_numpy(x), *dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_cubic_resize_512_to_518():
    """The main path's upsampling, on a crop of the main path's size."""
    x = np.random.default_rng(1).normal(size=(1, 512, 512, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.image.resize(jnp.asarray(x), (1, 518, 518, 3), "cubic")
    got = resize_cubic(torch.from_numpy(x), 518, 518)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def _vit_pair(ffn, **kw):
    base = dict(img_size=(28, 42), patch_size=14, embed_dim=32, depth=2, num_heads=4,
                use_cls_token=True, layerscale_init=1e-5, ffn=ffn)
    base.update(kw)
    jvit = JV.ViT(JV.ViTConfig(dtype=jnp.float32, **base))
    images = jnp.zeros((1, *base["img_size"], 3))
    params = _perturbed(jvit.init(jax.random.key(0), images), 3)
    tvit = flax_to_torch(params, TV.ViT(TV.ViTConfig(dtype=torch.float32, **base))).eval()
    return jvit, params, tvit


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_vit_keep_prefix_matches(ffn):
    jvit, params, tvit = _vit_pair(ffn)
    x = np.random.default_rng(4).normal(size=(2, 28, 42, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jvit.apply(params, jnp.asarray(x), keep_prefix=True)
        want_patches = jvit.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tvit(torch.from_numpy(x), keep_prefix=True)
        got_patches = tvit(torch.from_numpy(x))
    assert got.shape == (2, 1 + 2 * 3, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_patches.numpy(), np.asarray(want_patches), atol=ATOL)
    # the layerscale gammas were loaded from the tree (not left at their init)
    assert not torch.allclose(tvit.blocks[1].ls2, torch.full((32,), 1e-5))


def test_vit_out_layers_and_pos_embed_interpolation_match():
    """``out_layers`` (MoGe's readout) on an image whose grid is not the
    configured one, so the bicubic position-embedding resize runs."""
    jvit, params, tvit = _vit_pair("mlp", pos_interp_offset=0.1)
    x = np.random.default_rng(5).normal(size=(1, 42, 56, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        wl, wx, wc = jvit.apply(params, jnp.asarray(x), out_layers=(0, 1))
    with torch.no_grad():
        gl, gx, gc = tvit(torch.from_numpy(x), out_layers=(0, 1))
    for g, w in zip([*gl, gx, gc], [*wl, wx, wc]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def _conditioner_pair(jcfg, tcfg, seed):
    jcond = JH.Conditioner(jcfg)
    params = jcond.init(jax.random.key(0), jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3)))
    params = _perturbed(params, seed)
    tcond = flax_to_torch(params, TH.Conditioner(tcfg)).eval().requires_grad_(False)
    return jcond, params, tcond


@pytest.mark.parametrize("which", ["tiny", "swiglu"])
def test_encode_condition_matches(which):
    """``encode_condition`` on an RGBA image whose size is not the model's, so
    the normalisation and the cubic resize (down to 28 or up to 42) run."""
    if which == "tiny":
        jcfg, tcfg, size = JH.COND_TINY, TH.COND_TINY, 40
    else:
        kw = dict(image_size=42, patch_size=14, embed_dim=48, depth=2, heads=4, ffn="swiglu")
        jcfg = JH.ConditionerConfig(dtype=jnp.float32, **kw)
        tcfg = TH.ConditionerConfig(dtype=torch.float32, **kw)
        size = 36
    jcond, params, tcond = _conditioner_pair(jcfg, tcfg, 6)
    rgba = np.random.default_rng(7).integers(0, 256, (size, size, 4)).astype(np.uint8)
    with jax.default_matmul_precision("highest"):
        want, want_u = JGH.encode_condition(jcond, params, rgba)
    got, got_u = TGH.encode_condition(tcond, rgba, device="cpu")
    assert got.shape == (1, tcfg.n_tokens, tcfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), atol=0)


def test_conditioner_mask_channel_matches():
    """The optional mask channel: a fourth input channel, normalised by 0.5."""
    kw = dict(image_size=28, patch_size=14, embed_dim=32, depth=1, heads=2, ffn="mlp")
    jcfg = JH.ConditionerConfig(dtype=jnp.float32, **kw)
    tcfg = TH.ConditionerConfig(dtype=torch.float32, use_mask=True, **kw)
    jcond = JH.Conditioner(jcfg)
    img = np.random.default_rng(8).uniform(size=(1, 28, 28, 3)).astype(np.float32)
    mask = (np.random.default_rng(9).uniform(size=(1, 28, 28)) > 0.5).astype(np.float32)
    params = _perturbed(jcond.init(jax.random.key(0), jnp.asarray(img), jnp.asarray(mask)), 10)
    tcond = flax_to_torch(params, TH.Conditioner(tcfg)).eval()
    with jax.default_matmul_precision("highest"):
        want = jcond.apply(params, jnp.asarray(img), jnp.asarray(mask))["main"]
    with torch.no_grad():
        got = tcond(torch.from_numpy(img), torch.from_numpy(mask))["main"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_build_models_returns_a_frozen_conditioner_with_zero_uncond(monkeypatch):
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    dit, vae, cond = TGH.build_models(device="cpu")
    assert cond.cfg is TH.COND_TINY and dit.cfg.context_dim == TH.COND_TINY.embed_dim
    assert vae.cfg is TH.VAE_TINY
    assert not any(p.requires_grad for p in cond.parameters())
    assert torch.count_nonzero(cond.uncond_embedding) == 0
    assert cond.uncond_embedding.shape == (1, TH.COND_TINY.n_tokens, TH.COND_TINY.embed_dim)
    tokens, uncond = TGH.encode_condition(cond, np.zeros((64, 64, 4), np.uint8), device="cpu")
    assert tokens.shape == uncond.shape and torch.isfinite(tokens).all()
