"""The export of the PyTorch port against the JAX package: the two-level
decode (device part, host compose), the host marching tets, and the native
post-processing against its NumPy plain versions and against the JAX package.

Tolerances:
- logits and composed grids: 2e-5 absolute, float32 on both sides through a
  few narrow layers, as in test_torch_decode; the refine ids and their digest
  exactly (the selection is exact float32 arithmetic on values far from its
  thresholds here);
- meshes from the same grid: the same faces, vertices to 1e-6 (the same
  float64 interpolation in both packages' native code); from the two decodes,
  vertices to 1e-4 (a logit difference moves a vertex along its edge by the
  grid step times the difference over the edge's change of logit);
- post-processing: exact (the same native code, or a NumPy version of the
  same arithmetic), vertices to 1e-6 where NumPy sums in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followmyhold_tpu.diffusion import guidance as JG
from followmyhold_tpu.geometry import postprocess as JP
from followmyhold_tpu.models import hunyuan as JH
from followmyhold_tpu.ops import surface as JS
from followmyhold_tpu.ops.camera import GuidanceCamera as JCamera
from followmyhold_tpu_torch import native
from followmyhold_tpu_torch.configs.guidance import OptimizationConfig as TConfig
from followmyhold_tpu_torch.diffusion import guidance as TG
from followmyhold_tpu_torch.geometry import postprocess as TP
from followmyhold_tpu_torch.models import hunyuan as TH
from followmyhold_tpu_torch.ops import surface as TS
from followmyhold_tpu_torch.ops.camera import GuidanceCamera as TCamera
from followmyhold_tpu_torch.utils.params import flax_to_torch

BOX = 1.1
RES = 16


def _vae_pair():
    """A bridged tiny VAE whose field is smooth (only the lowest Fourier
    frequency of the query embedding), so its surface crosses some of the
    cells, and whose logit bias puts the surface inside the box."""
    kw = dict(num_latents=16, embed_dim=8, width=32, heads=4, depth=1, geo_heads=4)
    jvae = JH.ShapeVAE(JH.ShapeVAEConfig(dtype=jnp.float32, **kw))
    params = jax.tree_util.tree_map(
        np.asarray, jvae.init(jax.random.key(0), jnp.zeros((1, 16, 8)), jnp.zeros((1, 8, 3))))
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda x: x + rng.normal(scale=0.05, size=x.shape).astype(np.float32), params)
    kernel = params["params"]["geo"]["query_in"]["kernel"]
    keep = np.zeros(kernel.shape[0], bool)
    keep[[c * 17 + j for c in range(3) for j in (0, 1, 9)]] = True
    kernel[~keep] = 0.0
    tvae = flax_to_torch(params, TH.ShapeVAE(TH.ShapeVAEConfig(dtype=torch.float32, **kw)))
    tvae = tvae.eval().requires_grad_(False)
    lat = np.random.default_rng(7).normal(size=(1, 16, 8)).astype(np.float32)
    # centre the field on its median over the box, so that it has a surface
    xyz, _, _ = JG.generate_dense_grid_points([-BOX] * 3, [BOX] * 3, 8)
    with jax.default_matmul_precision("highest"):
        g = np.asarray(JH.vae_query_logits(jvae, params, jnp.asarray(lat), xyz[None], 512))
    params["params"]["geo"]["logit"]["bias"] -= np.float32(np.median(g))
    flax_to_torch(params, tvae)
    return jvae, params, tvae, lat


@pytest.fixture(scope="module")
def vae_pair():
    return _vae_pair()


def _jax_hier(jvae, params, lat, res, cell_cap):
    with jax.default_matmul_precision("highest"):
        return JH.vae_query_logits_hierarchical(
            jvae, params, jnp.asarray(lat), [-BOX] * 3, [BOX] * 3, res, chunk=256,
            coarse_factor=4, cell_cap=cell_cap)


def test_hierarchical_decode_matches_reference(vae_pair):
    """The device part: coarse grid, refine ids (and their digest), refine
    values and counts; then the composed grid."""
    jvae, params, tvae, lat = vae_pair
    jg_c, jids, jvals, jsel, jpts = _jax_hier(jvae, params, lat, RES, 4096)
    g_c, ids, vals, n_sel, n_pts = TH.vae_query_logits_hierarchical(
        tvae, torch.from_numpy(lat), [-BOX] * 3, [BOX] * 3, RES, chunk=256, cell_cap=4096)
    assert 0 < n_sel < (RES // 4) ** 3 and (n_sel, n_pts) == (int(jsel), int(jpts))
    np.testing.assert_allclose(g_c.numpy(), np.asarray(jg_c), atol=2e-5)
    jids = np.asarray(jids)[: int(jpts)]
    assert np.array_equal(ids.numpy(), jids)
    assert TH.refine_ids_digest(ids) == JH.refine_ids_digest(np.asarray(jids))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals)[: int(jpts)], atol=2e-5)
    got = TH.compose_hierarchical_grid(g_c.numpy(), vals.numpy(), RES, expect_n_pts=n_pts,
                                       pt_ids=ids.numpy())
    want = JH.compose_hierarchical_grid(np.asarray(jg_c), np.asarray(jvals)[: int(jpts)], RES,
                                        expect_n_pts=int(jpts), pt_ids=jids)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("cell_cap", [4096, 3], ids=["below_cap", "overflow"])
def test_device_and_host_refine_ids_are_bit_equal(vae_pair, cell_cap):
    """The host twin recomputes the device's ids from the same coarse grid,
    and the compose's canaries accept them."""
    _, _, tvae, lat = vae_pair
    g_c, ids, vals, n_sel, n_pts = TH.vae_query_logits_hierarchical(
        tvae, torch.from_numpy(lat), [-BOX] * 3, [BOX] * 3, RES, chunk=256, cell_cap=cell_cap)
    host = TH.refine_point_ids_host(g_c.numpy(), RES, cell_cap=cell_cap)
    assert np.array_equal(host, ids.numpy())
    a = TH.compose_hierarchical_grid(g_c.numpy(), vals.numpy(), RES, cell_cap=cell_cap,
                                     expect_n_pts=n_pts,
                                     expect_ids_digest=TH.refine_ids_digest(ids))
    b = TH.compose_hierarchical_grid(g_c.numpy(), vals.numpy(), RES, cell_cap=cell_cap,
                                     expect_n_pts=n_pts, pt_ids=ids.numpy())
    assert np.array_equal(a, b)
    with pytest.raises(RuntimeError, match="diverged"):
        TH.compose_hierarchical_grid(g_c.numpy(), vals.numpy(), RES, cell_cap=cell_cap,
                                     expect_n_pts=n_pts,
                                     expect_ids_digest=TH.refine_ids_digest(ids) + 1)


def test_capacity_overflow_warns_in_both_packages(vae_pair, capsys):
    jvae, params, tvae, lat = vae_pair
    with jax.default_matmul_precision("highest"):
        want = JH.hierarchical_export_logits(jvae, params, jnp.asarray(lat), BOX, RES,
                                             chunk=256, cell_cap=3)
    j_out = capsys.readouterr().out
    got = TH.hierarchical_export_logits(tvae, torch.from_numpy(lat), BOX, RES, chunk=256,
                                        cell_cap=3)
    t_out = capsys.readouterr().out
    assert "capacity overflow" in j_out and "capacity overflow" in t_out
    assert j_out.split("overflow: ")[1] == t_out.split("overflow: ")[1]
    np.testing.assert_allclose(got, want, atol=2e-5)


def _result_and_targets(lat):
    """A GuidanceResult with the identity poses and targets whose transform
    is the identity, in both packages."""
    size = 64
    tg = dict(mano_verts_moge=np.zeros((778, 3), np.float32),
              mano_faces=np.zeros((1538, 3), np.int64),
              j_regressor=np.zeros((16, 778), np.float32),
              hamer_2d_kps=np.zeros((21, 2), np.float32),
              moge_normal=np.zeros((size, size, 3), np.float32),
              moge_disp=np.zeros((size, size), np.float32),
              hand_mask=np.zeros((size, size), bool), obj_mask=np.zeros((size, size), bool),
              t_h2m=np.eye(4, dtype=np.float32))
    jpose = JG.init_pose()
    jres = JG.GuidanceResult(latents=jnp.asarray(lat), noise_pred=jnp.zeros_like(lat),
                             hand=jpose, obj=jpose)
    jtg = JG.GuidanceTargets(**{k: jnp.asarray(v) for k, v in tg.items()})
    tpose = TG.init_pose("cpu")
    tres = TG.GuidanceResult(latents=torch.from_numpy(lat), noise_pred=torch.zeros(1, 16, 8),
                             hand=tpose, obj=tpose)
    ttg = TG.GuidanceTargets(**{k: torch.from_numpy(v) for k, v in tg.items()})
    return size, (jres, jtg), (tres, ttg)


def test_export_meshes_host_path_matches_reference(vae_pair):
    """``export_meshes(..., device_res_limit=8)`` at 16^3 takes the two-level
    decode and the host extraction in both packages."""
    jvae, params, tvae, lat = vae_pair
    size, (jres, jtg), (tres, ttg) = _result_and_targets(lat)
    jsampler = JG.GuidedSampler(dit=None, vae=jvae, camera=JCamera(size, size, 60.0),
                                vae_chunk=256)
    tsampler = TG.GuidedSampler(dit=None, vae=tvae, camera=TCamera(size, size, 60.0),
                                config=TConfig(), vae_chunk=256)
    with jax.default_matmul_precision("highest"):
        jmesh, _ = jsampler.export_meshes(params, jres, jtg, octree_resolution=RES,
                                          device_res_limit=8)
    tmesh, _ = tsampler.export_meshes(tres, ttg, octree_resolution=RES, device_res_limit=8,
                                      device="cpu")
    assert tmesh.num_faces > 20 and tmesh.faces.shape[0] == jmesh.faces.shape[0]
    assert np.array_equal(tmesh.faces.numpy(), np.asarray(jmesh.faces))
    # a vertex moves along its edge by step * d(logit) / |s1 - s2|: 2e-5 of
    # logit is up to 4e-5 here (measured), so 1e-4
    np.testing.assert_allclose(tmesh.verts.numpy(), np.asarray(jmesh.verts), atol=1e-4)


def _sphere_sdf(res, r=0.8, wobble=0.05):
    ax = np.linspace(-BOX, BOX, res + 1, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - r + wobble * np.sin(5 * X)).astype(np.float32)


def _canonical_faces(v, f):
    """The faces as sorted vertex-coordinate triples, each rotated (winding
    kept) to start at its smallest corner: a mesh independent of numbering."""
    tri = np.round(v[f].astype(np.float64), 5)
    out = []
    for t in tri:
        k = min(range(3), key=lambda i: tuple(t[i]))
        out.append(tuple(np.roll(t, -k, axis=0).ravel()))
    return sorted(out)


@pytest.mark.parametrize("res", [12, 24])
def test_marching_tets_host_matches_reference_and_plain(res):
    sdf = _sphere_sdf(res)
    v, f = TS.marching_tets_host(sdf, [-BOX] * 3, [BOX] * 3, res)
    jv, jf = JS.marching_tets_host(sdf, [-BOX] * 3, [BOX] * 3, res)
    assert len(f) > 100 and np.array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=1e-6)
    step = np.full(3, 2 * BOX / res)
    pv, pf = TS._emit_cells_plain(sdf, TS._sign_change_cells(sdf, res),
                                  np.full(3, -BOX, np.float64), step)
    assert pf.shape == f.shape and _canonical_faces(pv, pf) == _canonical_faces(v, f)


def _two_spheres():
    """A watertight mesh of two components (a large and a small sphere) with
    a few degenerate faces appended."""
    v1, f1 = TS.marching_tets_host(_sphere_sdf(24), [-BOX] * 3, [BOX] * 3, 24)
    v2, f2 = TS.marching_tets_host(_sphere_sdf(8, r=0.5, wobble=0.0), [-BOX] * 3, [BOX] * 3, 8)
    v = np.concatenate([v1, v2 * 0.3 + 2.0]).astype(np.float32)
    f = np.concatenate([f1, f2 + len(v1), [[0, 0, 1], [2, 3, 3]]]).astype(np.int32)
    return v, f, len(v1)


def test_remove_floaters_native_plain_and_reference_agree():
    v, f, n_big = _two_spheres()
    got = TP.remove_floaters(v, f)
    want = JP.remove_floaters(v, f)
    assert len(got[0]) == n_big
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    # the native components against the plain union-find: the same largest one
    labels, main = native.connected_components(len(v), f)
    plain = TP.connected_components_plain(len(v), f)
    assert np.array_equal(labels == main, plain == np.argmax(np.bincount(plain)))


def test_remove_degenerate_faces_matches_reference():
    v, f, _ = _two_spheres()
    got = TP.remove_degenerate_faces(v, f)
    want = JP.remove_degenerate_faces(v, f)
    assert len(got[1]) <= len(f) - 2                 # marching tets' slivers go too
    assert not np.any(got[1][:, 0] == got[1][:, 1])
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("method", ["quadric", "grid"])
def test_reduce_faces_matches_reference(method):
    v, f = TS.marching_tets_host(_sphere_sdf(32), [-BOX] * 3, [BOX] * 3, 32)
    target = len(f) // 4
    got = TP.reduce_faces(v, f, max_faces=target, method=method)
    want = JP.reduce_faces(v, f, max_faces=target, method=method)
    assert 0 < len(got[1]) <= target
    assert np.array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)


@pytest.mark.parametrize("res", [64, 16])
def test_native_grid_decimation_matches_plain(res):
    v, f = TS.marching_tets_host(_sphere_sdf(32), [-BOX] * 3, [BOX] * 3, 32)
    lo, hi = v.min(0), v.max(0)
    got = native.decimate_grid(v, f, float((hi - lo).max() / res))
    want = TP.decimate_grid_plain(v, f, res)
    assert len(got[1]) == len(want[1]) and _canonical_faces(*got) == _canonical_faces(*want)


def test_reduce_faces_grid_floor_returns_best_effort(capsys):
    """The grid loop stops at 8 cells (the reference halves down to 2) and
    returns that mesh with a warning when the budget is still not met."""
    v, f = TS.marching_tets_host(_sphere_sdf(32), [-BOX] * 3, [BOX] * 3, 32)
    got_v, got_f = TP.reduce_faces(v, f, max_faces=10, method="grid")
    assert "returning that mesh" in capsys.readouterr().out
    lo, hi = v.min(0), v.max(0)
    at8 = native.decimate_grid(v, f, float((hi - lo).max() / 8))
    assert len(got_f) > 10 and np.array_equal(got_f, at8[1])
    assert np.array_equal(got_v, at8[0])


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No quiet fallback: a source that does not compile raises."""
    bad = tmp_path / "mesh_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        native.build_library()
