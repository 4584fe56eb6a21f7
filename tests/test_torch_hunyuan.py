"""DiT and ShapeVAE of the PyTorch port against the Flax modules, with the same
weights (through ``flax_to_torch``) and the same numpy inputs.

Float32 at tiny widths; tolerance 2e-5 absolute on outputs of order one
(measured 1.3e-6): the two frameworks sum matrix products, LayerNorm statistics
(Flax uses E[x^2]-E[x]^2) and softmax in another order, through a few layers. Every leaf
of the Flax trees is perturbed with seeded noise first, so that biases and norm
scales, which initialise to 0 and 1, are exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followmyhold_tpu.models import hunyuan as JH
from followmyhold_tpu_torch.models import hunyuan as TH
from followmyhold_tpu_torch.utils.params import flax_to_torch, init_random_

ATOL = 2e-5


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(scale=0.05, size=x.shape).astype(np.float32),
        params)


def _dit_pair(guidance_embed=False):
    jcfg = JH.DiTConfig(in_channels=8, hidden=64, heads=4, depth_double=2, depth_single=2,
                        context_dim=32, time_dim=32, guidance_embed=guidance_embed,
                        dtype=jnp.float32)
    tcfg = TH.DiTConfig(in_channels=8, hidden=64, heads=4, depth_double=2, depth_single=2,
                        context_dim=32, time_dim=32, guidance_embed=guidance_embed,
                        dtype=torch.float32)
    jdit = JH.HunyuanDiT(jcfg)
    params = jdit.init(jax.random.key(0), jnp.zeros((1, 16, 8)), jnp.zeros(1),
                       jnp.zeros((1, 4, 32)))
    params = _perturbed(params, 1)
    tdit = flax_to_torch(params, TH.HunyuanDiT(tcfg)).eval()
    return jdit, params, tdit


def _vae_pair():
    jcfg = JH.ShapeVAEConfig(num_latents=16, embed_dim=8, width=32, heads=4, depth=2,
                             geo_heads=4, dtype=jnp.float32)
    tcfg = TH.ShapeVAEConfig(num_latents=16, embed_dim=8, width=32, heads=4, depth=2,
                             geo_heads=4, dtype=torch.float32)
    jvae = JH.ShapeVAE(jcfg)
    params = jvae.init(jax.random.key(0), jnp.zeros((1, 16, 8)), jnp.zeros((1, 8, 3)))
    params = _perturbed(params, 2)
    tvae = flax_to_torch(params, TH.ShapeVAE(tcfg)).eval()
    return jvae, params, tvae


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding_matches(dim):
    t = np.array([0.0, 0.25, 1.0], np.float32)
    want = JH.timestep_embedding(jnp.asarray(t), dim)
    got = TH.timestep_embedding(torch.from_numpy(t), dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)  # args up to 1000


def test_fourier_embed_matches():
    x = np.random.default_rng(0).uniform(-1.1, 1.1, (2, 5, 3)).astype(np.float32)
    want = JH.fourier_embed(jnp.asarray(x), 8)
    got = TH.fourier_embed(torch.from_numpy(x), 8)
    assert got.shape == (2, 5, 51)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)  # args up to 141


@pytest.mark.parametrize("guidance_embed", [False, True])
def test_dit_matches_with_bridged_weights(guidance_embed):
    jdit, params, tdit = _dit_pair(guidance_embed)
    rng = np.random.default_rng(3)
    lat = rng.normal(size=(2, 16, 8)).astype(np.float32)
    cond = rng.normal(size=(2, 5, 32)).astype(np.float32)
    t = np.array([0.15, 0.8], np.float32)
    g = np.array([3.0, 7.5], np.float32) if guidance_embed else None
    with jax.default_matmul_precision("highest"):
        want = jdit.apply(params, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(cond),
                          None if g is None else jnp.asarray(g))
    with torch.no_grad():
        got = tdit(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(cond),
                   None if g is None else torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_vae_decode_and_geo_query_match_with_bridged_weights():
    jvae, params, tvae = _vae_pair()
    rng = np.random.default_rng(4)
    lat = rng.normal(size=(1, 16, 8)).astype(np.float32)
    pts = rng.uniform(-1.1, 1.1, (1, 40, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        feats = jvae.apply(params, jnp.asarray(lat))
        logits = jvae.apply(params, jnp.asarray(lat), jnp.asarray(pts))
        kv = JH.vae_decode_kv(jvae, params, jnp.asarray(lat))
    with torch.no_grad():
        tfeats = tvae(torch.from_numpy(lat))
        tlogits = tvae(torch.from_numpy(lat), torch.from_numpy(pts))
        tkv = TH.vae_decode_kv(tvae, torch.from_numpy(lat))
    np.testing.assert_allclose(tfeats.numpy(), np.asarray(feats), atol=ATOL)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), atol=ATOL)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(kv), atol=ATOL)


@pytest.mark.parametrize("chunk, group", [(16, 1), (16, 3), (64, 4)])
def test_vae_query_logits_chunked_matches(chunk, group):
    jvae, params, tvae = _vae_pair()
    rng = np.random.default_rng(5)
    lat = rng.normal(size=(1, 16, 8)).astype(np.float32)
    pts = rng.uniform(-1.1, 1.1, (1, 50, 3)).astype(np.float32)   # ragged last chunk
    with jax.default_matmul_precision("highest"):
        want = JH.vae_query_logits(jvae, params, jnp.asarray(lat), jnp.asarray(pts), 16)
    got = TH.vae_query_logits(tvae, torch.from_numpy(lat), torch.from_numpy(pts),
                              chunk=chunk, group=group)
    assert got.shape == (1, 50) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bridge_fills_every_parameter_and_rejects_mismatches():
    jdit, params, tdit = _dit_pair()
    np_params = jax.tree_util.tree_map(np.asarray, params)
    n_leaves = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(np_params))
    assert n_leaves == sum(p.numel() for p in tdit.parameters())
    # a layer's stacked weights land in that layer, transposed
    k = np.asarray(np_params["params"]["double_blocks"]["block"]["img_qkv"]["kernel"])
    np.testing.assert_array_equal(tdit.double_blocks[1].img_qkv.weight.detach().numpy(), k[1].T)

    missing = {"params": {k_: v for k_, v in np_params["params"].items() if k_ != "final_proj"}}
    with pytest.raises(KeyError, match="final_proj"):
        flax_to_torch(missing, TH.HunyuanDiT(tdit.cfg))
    extra = {"params": dict(np_params["params"], stray={"kernel": np.zeros((2, 2), np.float32)})}
    with pytest.raises(KeyError, match="stray"):
        flax_to_torch(extra, TH.HunyuanDiT(tdit.cfg))


def test_random_init_is_seeded_and_well_scaled():
    a = init_random_(TH.ShapeVAE(TH.VAE_TINY), seed=3)
    b = init_random_(TH.ShapeVAE(TH.VAE_TINY), seed=3)
    c = init_random_(TH.ShapeVAE(TH.VAE_TINY), seed=4)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
        if pa.dim() >= 2:
            assert not torch.equal(pa, pc), name
    assert torch.all(a.decoder.ln_post.weight == 1) and torch.all(a.geo.kv.bias == 0)
    out = a(torch.zeros(1, 16, 8) + 0.3, torch.zeros(1, 5, 3))
    assert torch.isfinite(out).all()


def test_build_models_needs_an_existing_device_and_freezes_weights():
    from followmyhold_tpu_torch.geometry.hunyuan import build_models

    dit, vae = build_models(TH.DIT_TINY, TH.VAE_TINY, device="cpu")
    assert not dit.training and not any(p.requires_grad for p in vae.parameters())
    assert dit.cfg is TH.DIT_TINY and vae.cfg is TH.VAE_TINY
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_models(TH.DIT_TINY, TH.VAE_TINY)
