"""FLUX.1-Kontext in the PyTorch port (``models/flux.py``: the transformer,
the VAE, packing and ``kontext_edit``; ``ops/norms.group_norm_f32``) against
the JAX package, on the same numpy inputs and, through ``flax_to_torch``, the
same weights: the reference's tiny configurations (``FLUX_TINY_TEST``,
``FLUX_VAE_TINY``) and a 32x32 image, float32 on both sides. The
transformer's joint sequence is 64 noisy + 64 context + 160 text tokens, so
the port's attention takes its flash path (the kernel's plain version on the
CPU) where the JAX package's takes its XLA one off the TPU. The noise of
``kontext_edit`` is drawn on the JAX side and injected.

Tolerances (measured on the CPU with these seeds):
- ``pack_latents`` / ``unpack_latents`` / ``latent_ids``: exactly;
- ``apply_rope``: exactly; ``rope_freqs`` (ids of a 512^2 crop): 2 float32
  ulps of 1, the two libraries' sin and cos (measured 6.0e-8);
  ``sinusoidal_embedding`` at t*1000: 1e-4 absolute, because the two
  libraries' exp differ by one ulp in 14 of the 128 frequencies and the
  angles reach 1000 rad, where one ulp is 6.1e-5 (measured 2.2e-5);
- ``kontext_sigmas``: 1e-6 (``jnp.linspace``'s formula, which XLA may fuse
  into an FMA; measured 8.9e-8 at 28 steps, 0 at 2);
- ``FluxVae.encode`` and ``decode``: 1e-5 of each output's largest entry
  (the same products summed in another order; measured <= 7.8e-7 of it);
- the transformer: 5e-5 of its output's largest entry (measured 1.2e-5; 9.6e-7
  with the JAX package's timestep embedding put in place of the port's, so
  the rest is the embedding's exp, above);
- ``kontext_edit``, 2 steps: 1e-4 of the image's largest value, 1 (measured
  2.7e-6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import followmyhold_tpu.ops.attention  # noqa: F401  (imported before any jit traces it)
from followmyhold_tpu.models import flux as JF
from followmyhold_tpu_torch.models import flux as TF
from followmyhold_tpu_torch.ops import _kernels
from followmyhold_tpu_torch.ops.rope import apply_rope
from followmyhold_tpu_torch.utils.params import flax_to_torch

N_TXT = 160


def random_params(init, seed):
    """A Flax tree of the shapes ``init(key)`` makes (``jax.eval_shape``: no
    compile, no init run), filled from ``seed`` with numpy: kernels and
    embeddings N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2), the rest
    N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("kernel", "embedding"):
            fan_in = int(np.prod(leaf.shape[:-1])) if name == "kernel" else leaf.shape[-1]
            return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + rng.normal(scale=0.05, size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init, jax.random.key(0)))


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@functools.lru_cache(maxsize=None)
def _models():
    """Both packages' tiny transformer and VAE with the same random weights,
    built once for the module."""
    c = JF.FLUX_TINY_TEST
    tr, vae = JF.FluxTransformer(c), JF.FluxVae(JF.FLUX_VAE_TINY)
    n = 8
    t_params = random_params(lambda k: tr.init(
        k, jnp.zeros((1, n, c.in_channels)), jnp.zeros((1, 4, c.joint_dim)),
        jnp.zeros((1, c.pooled_dim)), jnp.ones((1,)), jnp.zeros((n, 3)), jnp.zeros((4, 3)),
        jnp.ones((1,))), 1)
    v_params = random_params(lambda k: vae.init(k, jnp.zeros((1, 32, 32, 3))), 2)
    t_tr = flax_to_torch(t_params, TF.FluxTransformer(TF.FLUX_TINY_TEST, device="cpu")).eval()
    t_vae = flax_to_torch(v_params, TF.FluxVae(TF.FLUX_VAE_TINY, device="cpu")).eval()
    return (tr, t_params, vae, v_params), (t_tr, t_vae)


def _conditions(seed=3):
    rng = np.random.default_rng(seed)
    c = JF.FLUX_TINY_TEST
    t5 = rng.normal(size=(1, N_TXT, c.joint_dim)).astype(np.float32)
    pooled = rng.normal(size=(1, c.pooled_dim)).astype(np.float32)
    image = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    return t5, pooled, image


# ---- the exact pieces ----------------------------------------------------- #

def test_pack_unpack_and_ids_are_exact():
    z = np.random.default_rng(0).normal(size=(2, 6, 10, 4)).astype(np.float32)
    packed = TF.pack_latents(_t(z)).numpy()
    np.testing.assert_array_equal(packed, np.asarray(JF.pack_latents(jnp.asarray(z))))
    np.testing.assert_array_equal(TF.unpack_latents(_t(packed), 6, 10).numpy(), z)
    np.testing.assert_array_equal(
        np.asarray(JF.unpack_latents(jnp.asarray(packed), 6, 10)), z)
    for t in (0, 1):
        np.testing.assert_array_equal(TF.latent_ids(3, 5, t), JF.latent_ids(3, 5, t))


def test_sinusoidal_embedding_and_rope_match():
    t = np.asarray([0.0, 0.37, 1.0], np.float32)
    want = np.asarray(JF.sinusoidal_embedding(jnp.asarray(t) * 1000.0, 256))
    got = TF.sinusoidal_embedding(_t(t) * 1000.0, 256).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    ids = np.concatenate([np.zeros((5, 3), np.float32), JF.latent_ids(32, 32, 0),
                          JF.latent_ids(32, 32, 1)])
    got_cos, got_sin = TF.rope_freqs(_t(ids), (16, 56, 56))
    want_cos, want_sin = JF.rope_freqs(jnp.asarray(ids), (16, 56, 56))
    assert got_cos.shape == (2053, 64)
    two_ulps = 2 * np.finfo(np.float32).eps
    np.testing.assert_allclose(got_cos.numpy(), want_cos, atol=two_ulps, rtol=0)
    np.testing.assert_allclose(got_sin.numpy(), want_sin, atol=two_ulps, rtol=0)
    x = np.random.default_rng(1).normal(size=(1, 2, 2053, 128)).astype(np.float32)
    got = apply_rope(_t(x), _t(want_cos), _t(want_sin)).numpy()
    np.testing.assert_array_equal(got, JF.apply_rope(jnp.asarray(x), want_cos, want_sin))
    # interleaved (even, odd) pairs: each pair keeps its length
    np.testing.assert_allclose(np.hypot(got[..., 0::2], got[..., 1::2]),
                               np.hypot(x[..., 0::2], x[..., 1::2]), rtol=1e-5)


@pytest.mark.parametrize("steps,n_img", [(28, 1024), (2, 64)])
def test_kontext_sigmas_match(steps, n_img):
    mu = 0.5 + (n_img - 256) * (1.15 - 0.5) / (4096 - 256)
    base = jnp.linspace(1.0, 1.0 / steps, steps)
    want = np.concatenate([np.asarray(np.exp(mu) / (np.exp(mu) + (1.0 / base - 1.0))), [0.0]])
    got = TF.kontext_sigmas(steps, n_img)
    assert got.dtype == np.float32 and got.shape == (steps + 1,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert got[0] == 1.0 and got[-1] == 0.0 and (np.diff(got) < 0).all()


# ---- the models ----------------------------------------------------------- #

def test_transformer_matches_jax():
    (tr, t_params, _, _), (t_tr, _) = _models()
    c = JF.FLUX_TINY_TEST
    rng = np.random.default_rng(4)
    t5, pooled, _ = _conditions()
    hidden = rng.normal(size=(1, 128, c.in_channels)).astype(np.float32)
    img_ids = np.concatenate([JF.latent_ids(8, 8, 0), JF.latent_ids(8, 8, 1)])
    txt_ids = np.zeros((N_TXT, 3), np.float32)
    t, g = np.asarray([0.7], np.float32), np.asarray([2.5], np.float32)
    want = jax.jit(tr.apply)(t_params, hidden, t5, pooled, t, img_ids, txt_ids, g)
    _kernels.reset_launch_counts()
    with torch.no_grad():
        got = t_tr(_t(hidden), _t(t5), _t(pooled), _t(t), _t(img_ids), _t(txt_ids), _t(g))
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 5e-5)
    assert _kernels.launch_counts()["flash_attention_fwd"] == 0   # the CPU runs the plain version


def test_vae_encode_and_decode_match_jax():
    (_, _, vae, v_params), (_, t_vae) = _models()
    _, _, image = _conditions()
    x = image * 2.0 - 1.0
    want_z = jax.jit(lambda p, x: vae.apply(p, x, method=JF.FluxVae.encode))(v_params, x)
    with torch.no_grad():
        got_z = t_vae.encode(_t(x))
    assert got_z.shape == (1, 16, 16, 4)
    _close(got_z.numpy(), want_z, 1e-5)
    z = np.asarray(want_z)
    want = jax.jit(lambda p, z: vae.apply(p, z, method=JF.FluxVae.decode))(v_params, z)
    with torch.no_grad():
        got = t_vae.decode(_t(z))
    assert got.shape == (1, 32, 32, 3)
    _close(got.numpy(), want, 1e-5)


def test_kontext_edit_matches_jax_with_its_noise():
    (tr, t_params, vae, v_params), (t_tr, t_vae) = _models()
    t5, pooled, image = _conditions()
    key = jax.random.key(7)
    noise = np.asarray(jax.random.normal(key, (1, 64, 16), jnp.float32))
    want = JF.kontext_edit(tr, t_params, vae, v_params, jnp.asarray(t5), jnp.asarray(pooled),
                           jnp.asarray(image), key, num_steps=2, guidance=2.5)
    with torch.no_grad():
        got = TF.kontext_edit(t_tr, t_vae, _t(t5), _t(pooled), _t(image), num_steps=2,
                              guidance=2.5, initial_noise=noise)
    assert got.shape == (1, 32, 32, 3) and 0.0 <= got.min() and got.max() <= 1.0
    _close(got.numpy(), want, 1e-4)
    with pytest.raises(ValueError, match="initial_noise"):
        TF.kontext_edit(t_tr, t_vae, _t(t5), _t(pooled), _t(image), num_steps=2,
                        initial_noise=noise[:, :32])
