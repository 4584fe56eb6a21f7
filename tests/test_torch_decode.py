"""The differentiable ShapeVAE grid decode of the PyTorch port, dense and
two-level, against the JAX package with the same weights (through the bridge).

- The dense decode: logits and their gradient with respect to the latents,
  in every rematerialisation mode and with and without block checkpointing.
- The two-level in-loop decode: dense logits, the capacity indicator and the
  gradient, on a bridged tiny VAE whose field has a surface, below the caps
  and with a cap small enough to overflow.
- The port's two-level decode against its own dense decode, equal wherever
  marching tets emits geometry, on an analytic sphere whose centre follows the
  latents (the contract of the reference's tests/test_hierarchical_decode.py).

Tolerances: float32 on both sides through a few layers; logits to 2e-5 as in
test_torch_hunyuan (sums in another order), gradients to 2e-5 relative to
their largest entry (measured below 1e-6). The capacity indicator exactly.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followmyhold_tpu.models import hunyuan as JH
from followmyhold_tpu_torch.models import hunyuan as TH
from followmyhold_tpu_torch.ops.surface import marching_tets
from followmyhold_tpu_torch.utils.params import flax_to_torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module on one torch thread: the port's small ops spin a thread
    pool for nothing, and in a six-worker run of the suite that CPU time is
    what the file costs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BOX = 1.1


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _vae_pair(depth=2, smooth=False, remat_blocks=True):
    """A bridged tiny VAE. ``smooth`` keeps only the lowest Fourier frequency
    of the geo query embedding, so the random-weight field is smooth and its
    surface crosses a fraction of the cells instead of all of them."""
    kw = dict(num_latents=16, embed_dim=8, width=32, heads=4, depth=depth, geo_heads=4)
    jvae = JH.ShapeVAE(JH.ShapeVAEConfig(dtype=jnp.float32, **kw))
    params = _np(jvae.init(jax.random.key(0), jnp.zeros((1, 16, 8)), jnp.zeros((1, 8, 3))))
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda x: x + rng.normal(scale=0.05, size=x.shape).astype(np.float32), params)
    if smooth:
        kernel = params["params"]["geo"]["query_in"]["kernel"]
        keep = np.zeros(kernel.shape[0], bool)
        keep[[c * 17 + j for c in range(3) for j in (0, 1, 9)]] = True
        kernel[~keep] = 0.0
    tvae = flax_to_torch(params, TH.ShapeVAE(TH.ShapeVAEConfig(
        dtype=torch.float32, remat_blocks=remat_blocks, **kw))).eval().requires_grad_(False)
    return jvae, params, tvae


def _assert_grads_close(got, want):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=2e-5 * scale)


@pytest.mark.parametrize("remat_blocks", [True, False], ids=["block_remat", "no_block_remat"])
@pytest.mark.parametrize("remat", ["none", "tail", "full"])
def test_dense_decode_values_and_gradients_match(remat, remat_blocks):
    jvae, params, tvae = _vae_pair(remat_blocks=remat_blocks)
    rng = np.random.default_rng(5)
    lat = rng.normal(size=(1, 16, 8)).astype(np.float32)
    pts = rng.uniform(-BOX, BOX, (1, 50, 3)).astype(np.float32)   # ragged last chunk
    w = rng.normal(size=(1, 50)).astype(np.float32)

    def jloss(lat_):
        return jnp.sum(JH.vae_query_logits(jvae, params, lat_, jnp.asarray(pts), 16,
                                           remat=remat) * w)

    with jax.default_matmul_precision("highest"):
        want = JH.vae_query_logits(jvae, params, jnp.asarray(lat), jnp.asarray(pts), 16,
                                   remat=remat)
        want_g = jax.grad(jloss)(jnp.asarray(lat))
    tl = torch.from_numpy(lat).requires_grad_(True)
    got = TH.vae_query_logits(tvae, tl, torch.from_numpy(pts), chunk=16, group=2, remat=remat)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)
    _assert_grads_close(tl.grad.numpy(), np.asarray(want_g))


def test_unknown_remat_mode_is_refused():
    _, _, tvae = _vae_pair(depth=1)
    with pytest.raises(ValueError, match="remat"):
        TH.vae_query_logits(tvae, torch.zeros(1, 16, 8), torch.zeros(1, 4, 3), remat="some")


@pytest.mark.parametrize("cell_cap", [10240, 8], ids=["below_caps", "overflow"])
def test_hier_grid_matches_reference(cell_cap):
    """Dense logits, capacity indicator and d(loss)/d(latents) of the two-level
    decode at 8^3 (coarse 4^3 cells) against the JAX decode."""
    res = 8
    jvae, params, tvae = _vae_pair(smooth=True)
    rng = np.random.default_rng(7)
    lat = rng.normal(size=(1, 16, 8)).astype(np.float32)
    w = rng.normal(size=(1, (res + 1) ** 3)).astype(np.float32)

    def jdecode(lat_):
        return JH.vae_query_logits_hier_grid(jvae, params, lat_, [-BOX] * 3, [BOX] * 3, res,
                                             chunk=64, coarse_factor=2, cell_cap=cell_cap)

    with jax.default_matmul_precision("highest"):
        want, want_n = jdecode(jnp.asarray(lat))
        want_g = jax.grad(lambda l_: jnp.sum(jdecode(l_)[0] * w))(jnp.asarray(lat))
    tl = torch.from_numpy(lat).requires_grad_(True)
    got, got_n = TH.vae_query_logits_hier_grid(tvae, tl, [-BOX] * 3, [BOX] * 3, res, chunk=64,
                                               coarse_factor=2, cell_cap=cell_cap)
    (got * torch.from_numpy(w)).sum().backward()
    assert got.shape == (1, (res + 1) ** 3)
    assert got_n == int(want_n)
    if cell_cap < 64:
        assert got_n > cell_cap                  # the indicator reports the overflow
    else:
        assert 0 < got_n < 64                    # a surface, below every cap
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)
    _assert_grads_close(tl.grad.numpy(), np.asarray(want_g))


def test_hier_grid_small_cap_has_no_effect():
    _, _, tvae = _vae_pair(depth=1, smooth=True)
    lat = torch.from_numpy(np.random.default_rng(8).normal(size=(1, 16, 8)).astype(np.float32))
    kw = dict(chunk=64, coarse_factor=2, cell_cap=64)
    a, na = TH.vae_query_logits_hier_grid(tvae, lat, [-BOX] * 3, [BOX] * 3, 8, **kw)
    b, nb = TH.vae_query_logits_hier_grid(tvae, lat, [-BOX] * 3, [BOX] * 3, 8,
                                          small_cell_cap=16, **kw)
    assert torch.equal(a, b) and na == nb


class _LatentSphere:
    """Stand-in for the ShapeVAE whose geo query evaluates a sphere of radius
    0.55 centred at a differentiable function of the latents (the k/v pass
    through), so two-level and dense decodes are comparable on a Lipschitz
    field; logits = -sdf."""

    cfg = types.SimpleNamespace(scale_factor=1.0)

    def __init__(self):
        self.decoder = lambda x: x
        self.geo = self

    def kv_feats(self, feats):
        return feats

    def query(self, q, kv):
        center = torch.tanh(kv.reshape(kv.shape[0], -1)[:, :3]) * 0.3
        return -(torch.linalg.norm(q - center[:, None, :], dim=-1) - 0.55)

    def query_head(self, q, kv):
        return q, kv

    def query_tail(self, q, kv):
        return self.query(q, kv)


def _mesh_loss(logits, res):
    mesh = marching_tets(-logits, [-BOX] * 3, [BOX] * 3, res, max_verts=8192, max_faces=16384)
    w = torch.sin(torch.arange(mesh.verts.numel(), dtype=torch.float32)).reshape(mesh.verts.shape)
    return (mesh.verts * w * mesh.vert_mask[:, None]).sum(), mesh


@pytest.mark.parametrize("remat", ["none", "tail"])
def test_hier_grid_equals_dense_where_marching_tets_emits_geometry(remat):
    res = 32
    vae = _LatentSphere()
    n = res + 1
    ax = torch.linspace(-BOX, BOX, n)
    xyz = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1).reshape(1, -1, 3)
    grads, meshes, values = [], [], []
    for hier in (False, True):
        lat = torch.tensor([[[0.3, -0.2, 0.1, 0.05]]], requires_grad=True)
        if hier:
            logits, n_sel = TH.vae_query_logits_hier_grid(
                vae, lat, [-BOX] * 3, [BOX] * 3, res, chunk=4096, coarse_factor=2,
                cell_cap=2048, remat=remat)
            assert 0 < n_sel <= 2048
        else:
            logits = TH.vae_query_logits(vae, lat, xyz, chunk=4096, remat=remat)
        loss, mesh = _mesh_loss(logits[0], res)
        loss.backward()
        grads.append(lat.grad.numpy())
        meshes.append(mesh)
        values.append(loss.item())
    dense, hier = meshes
    assert dense.num_faces > 100 and hier.num_faces == dense.num_faces
    assert torch.equal(hier.faces, dense.faces)
    np.testing.assert_allclose(hier.verts.detach().numpy(), dense.verts.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(values[1], values[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-4, atol=1e-5)
    assert np.abs(grads[0]).max() > 1e-4          # the gradient is not trivial
