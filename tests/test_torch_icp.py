"""ICP and the two alignment stages of the PyTorch port (``ops/icp.py``,
``alignment/{mesh_align,h2m,mano}.py``) against the JAX package, on the same
numpy point sets and meshes.

The surface samples and the init transform are numpy on both sides, so they
must agree bit for bit. ICP iterates a contraction: nearest neighbours by
the same direct (a - b)^2 sums, a Procrustes step through each library's
3x3 SVD, so float32 rounding does not grow from one iteration to the next.

Tolerances, float32 on both sides (measured on the CPU with these seeds):
- ``procrustes``: 1e-5 absolute on the 4x4 (unit-scale points); measured
  <= 5.3e-7;
- ``icp`` and the alignments: 1e-4 absolute on the transforms and the cost
  (a nearest neighbour at a tie may differ and shift a step by one point's
  share); measured <= 3.5e-6;
- the aligned MANO mesh: 1e-4 on its vertices; measured 1.4e-6.
The checks against the true transform (that ICP found it at all) are
looser: 2e-2 for Procrustes on noisy points (measured 2.6e-3), 0.1 for the
cut-down alignment of a scale-1.8 transform (measured 4.7e-2).

The stages run at the reference's knobs except the sample counts and
iterations, cut (both packages alike, through their ``align_meshes_impl``)
to keep the dense nearest-neighbour search small on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followmyhold_tpu.alignment import h2m as JH2M
from followmyhold_tpu.alignment import mano as JMA
from followmyhold_tpu.alignment import mesh_align as JMAL
from followmyhold_tpu.ops import icp as JICP
from followmyhold_tpu.utils import mesh_io as JIO
from followmyhold_tpu_torch.alignment import h2m as TH2M
from followmyhold_tpu_torch.alignment import mano as TMA
from followmyhold_tpu_torch.alignment import mesh_align as TMAL
from followmyhold_tpu_torch.models.mano import synthetic_mano
from followmyhold_tpu_torch.ops import icp as TICP
from followmyhold_tpu_torch.utils import mesh_io as TIO

# the stages' sample counts and iterations, cut for the CPU
SMALL = dict(count_source_coarse=200, count_target_coarse=600, iterations_coarse=15,
             count_source_fine=400, count_target_fine=900, iterations_fine=20)


def _rotation(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _similarity(scale, axis, angle, t):
    T = np.eye(4)
    T[:3, :3] = scale * _rotation(axis, angle)
    T[:3, 3] = t
    return T.astype(np.float32)


def _apply(T, p):
    return (p @ T[:3, :3].T + T[:3, 3]).astype(np.float32)


def _blob(rows=14, cols=20, seed=0):
    """A closed, bumpy, elongated surface (a UV sphere), so that ICP has
    one clear optimum -> (verts, faces int32)."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0.1, np.pi - 0.1, rows)[:, None]
    ph = np.linspace(0, 2 * np.pi, cols, endpoint=False)[None]
    r = 1.0 + 0.15 * np.sin(3 * ph) * np.sin(2 * th) + 0.02 * rng.normal(size=(rows, cols))
    v = np.stack([1.6 * r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                  0.7 * r * np.cos(th) + 0 * ph], -1).reshape(-1, 3)
    v = np.concatenate([v, [[0, 0, 0.75], [0, 0, -0.75]]]).astype(np.float32)
    idx = np.arange(rows * cols).reshape(rows, cols)
    a, b = idx[:-1], idx[1:]
    a1, b1 = np.roll(a, -1, 1), np.roll(b, -1, 1)
    faces = np.concatenate([np.stack([a, b, a1], -1).reshape(-1, 3),
                            np.stack([a1, b, b1], -1).reshape(-1, 3)])
    top, bot = rows * cols, rows * cols + 1
    faces = np.concatenate([faces, np.stack([np.full(cols, top), idx[0], np.roll(idx[0], -1)], -1),
                            np.stack([np.full(cols, bot), np.roll(idx[-1], -1), idx[-1]], -1)])
    return v, faces.astype(np.int32)


def _icp_pair(**kw):
    with jax.default_matmul_precision("highest"):
        args = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        want = JICP.icp(**args)
    args = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    got = TICP.icp(**args)
    return got, want


@pytest.mark.parametrize("weighted,reflected", [(False, False), (True, False), (True, True)],
                         ids=["plain", "weighted", "reflection_refused"])
def test_procrustes_matches_reference(weighted, reflected):
    rng = np.random.default_rng(1)
    p = rng.normal(size=(64, 3)).astype(np.float32)
    T = _similarity(1.4, [1, 2, 0.5], 0.7, [0.3, -0.2, 0.9])
    q = _apply(T, p) + rng.normal(scale=0.01, size=p.shape).astype(np.float32)
    if reflected:
        q[:, 0] *= -1.0
    w = rng.uniform(size=64).astype(np.float32) * (np.arange(64) % 5 != 0) if weighted else None
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JICP.procrustes(jnp.asarray(p), jnp.asarray(q),
                                          None if w is None else jnp.asarray(w)))
    got = TICP.procrustes(torch.from_numpy(p), torch.from_numpy(q),
                          None if w is None else torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.linalg.det(got[:3, :3]) > 0          # never a reflection
    if not reflected:
        np.testing.assert_allclose(got, T, atol=0.02)
    fixed = TICP.procrustes(torch.from_numpy(p), torch.from_numpy(q), scale=False).numpy()
    np.testing.assert_allclose(np.linalg.norm(fixed[:3, 0]), 1.0, atol=1e-5)


@pytest.mark.parametrize("case", [
    dict(outliers=0.0, n_iter=12),
    dict(outliers=0.2, n_iter=12),
    dict(outliers=0.2, n_iter=12, min_scale=0.9, max_scale=1.1),      # the clamp binds
    dict(outliers=0.2, n_iter=8, fixed_scale=True),
    dict(outliers=0.2, n_iter=6, restarts=True),
], ids=["plain", "outliers", "scale_clamp", "fixed_scale", "restarts"])
def test_icp_matches_reference(case):
    case = dict(case)
    restarts = case.pop("restarts", False)
    v, f = _blob()
    src = TICP.sample_surface(v, f, 300, seed=3)
    T = _similarity(1.3, [0.2, 1, 0.3], 0.35 if not restarts else 2.6, [0.1, 0.05, -0.1])
    tgt = _apply(T, TICP.sample_surface(v, f, 700, seed=4))
    # a cluster of target outliers far from the surface
    tgt[:60] = tgt[:60] * 0.2 + np.array([3.0, 0.0, 0.0], np.float32)
    init = TICP.axis_aligned_restarts() if restarts else None
    got, want = _icp_pair(source_points=src, target_points=tgt, init_transforms=init, **case)
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-4)
    np.testing.assert_allclose(got.cost.item(), float(want.cost), atol=1e-4)
    s = np.linalg.norm(got.transform.numpy()[:3, 0])
    assert case.get("min_scale", 0.5) - 1e-6 <= s <= case.get("max_scale", 2.0) + 1e-6
    if case.get("fixed_scale"):
        assert abs(s - 1.0) < 1e-5


def test_init_transform_samples_and_restarts_are_the_reference_s():
    v, f = _blob(seed=2)
    for seed in (0, 5):
        np.testing.assert_array_equal(TICP.sample_surface(v, f, 333, seed),
                                      JICP.sample_surface(v, f, 333, seed))
    zero = np.zeros((4, 3), np.float32)           # zero-area faces: uniform draws
    np.testing.assert_array_equal(TICP.sample_surface(zero, f[:5] % 4, 50, 1),
                                  JICP.sample_surface(zero, f[:5] % 4, 50, 1))
    tgt = _apply(_similarity(2.0, [1, 0, 0], 0.3, [1, 2, 3]), v)
    for fixed in (False, True):
        np.testing.assert_array_equal(TICP.compute_init_transform(v, tgt, fixed),
                                      JICP.compute_init_transform(v, tgt, fixed))
    for kw in (dict(), dict(rotations=False), dict(reflections=False, include_identity=False)):
        np.testing.assert_array_equal(TICP.axis_aligned_restarts(**kw),
                                      JICP.axis_aligned_restarts(**kw))
    assert TICP.axis_aligned_restarts().shape == (17, 4, 4)


def _both_align(monkeypatch):
    """Both packages' align_meshes_impl with the counts cut (SMALL)."""
    for module, impl in ((JH2M, JMAL.align_meshes_impl), (JMA, JMAL.align_meshes_impl),
                         (TH2M, TMAL.align_meshes_impl), (TMA, TMAL.align_meshes_impl)):
        monkeypatch.setattr(module, "align_meshes_impl",
                            lambda *a, _impl=impl, **k: _impl(*a, **{**k, **SMALL}))


def test_align_meshes_impl_matches_reference(tmp_path):
    v, f = _blob(seed=6)
    T = _similarity(1.8, [0.3, 0.2, 1.0], 0.3, [0.5, -0.4, 2.0])
    src, tgt = str(tmp_path / "src.ply"), str(tmp_path / "tgt.ply")
    TIO.write_ply(src, v, f)
    TIO.write_ply(tgt, _apply(T, v), f)
    out = {}
    for name, impl in (("jax", JMAL.align_meshes_impl), ("torch", TMAL.align_meshes_impl)):
        kw = dict(transform_path=str(tmp_path / f"{name}_T"),
                  transformed_mesh_path=str(tmp_path / f"{name}.ply"), **SMALL)
        if name == "torch":
            kw["device"] = "cpu"
        with jax.default_matmul_precision("highest"):
            out[name] = impl(src, tgt, **kw)
    np.testing.assert_allclose(out["torch"], out["jax"], atol=1e-4)
    np.testing.assert_array_equal(np.load(tmp_path / "torch_T.npy"), out["torch"])
    np.testing.assert_allclose(out["torch"], T, atol=0.1)       # it found the transform
    moved = TIO.load_mesh(str(tmp_path / "torch.ply"))
    np.testing.assert_allclose(moved.vertices, _apply(out["torch"], v), atol=1e-5)
    np.testing.assert_array_equal(moved.faces, f)


def _stage_inputs(root, image_id="000005"):
    """A Hunyuan HOI mesh, its MoGe mesh (the object moved and scaled), and a
    HaMeR hand placed near the object -> the directories."""
    d = {k: os.path.join(root, k) for k in ("hunyuan", "moge", "hamer", "h2m", "aligned")}
    for k in ("hunyuan", "hamer"):
        os.makedirs(d[k])
    v, f = _blob(seed=7)
    TIO.write_ply(os.path.join(d["hunyuan"], f"{image_id}_hoi_mesh.ply"), v, f)
    moge = os.path.join(d["moge"], f"{image_id}_cropped_hoi")
    os.makedirs(moge)
    TIO.write_ply(os.path.join(moge, "mesh.ply"),
                  _apply(_similarity(0.4, [0, 1, 0.2], 0.25, [0.0, 0.1, -0.8]), v), f)
    mano = synthetic_mano(device="cpu")
    hand = mano.v_template.numpy() * 6.0 + np.array([0.9, 0.2, 0.1], np.float32)
    TIO.write_obj(os.path.join(d["hamer"], f"{image_id}_hamer.obj"), hand, mano.faces.numpy())
    return d


def test_h2m_and_mano_runs_match_reference(tmp_path, monkeypatch, capsys):
    _both_align(monkeypatch)
    out = {}
    for name, h2m, mano in (("jax", JH2M.run, JMA.run), ("torch", TH2M.run, TMA.run)):
        d = _stage_inputs(str(tmp_path / name))
        kw = {"device": "cpu"} if name == "torch" else {}
        with jax.default_matmul_precision("highest"):
            h2m(d["hunyuan"], d["moge"], d["h2m"], **kw)
            mano(d["hamer"], d["hunyuan"], d["aligned"], **kw)
        assert sorted(os.listdir(d["h2m"])) == ["000005_hoi_mesh.npy"]
        assert sorted(os.listdir(d["aligned"])) == ["000005_hamer_aligned_mano.ply"]
        out[name] = (np.load(os.path.join(d["h2m"], "000005_hoi_mesh.npy")),
                     JIO.load_mesh(os.path.join(d["aligned"], "000005_hamer_aligned_mano.ply")))
        # a second run skips both
        capsys.readouterr()
        h2m(d["hunyuan"], d["moge"], d["h2m"], **kw)
        mano(d["hamer"], d["hunyuan"], d["aligned"], **kw)
        printed = capsys.readouterr().out
        assert "000005 transform exists, skipping" in printed
        assert "000005 aligned mano exists, skipping" in printed
    (jT, jm), (tT, tm) = out["jax"], out["torch"]
    assert tT.dtype == np.float32 and np.isfinite(tT).all()
    np.testing.assert_allclose(tT, jT, atol=1e-4)
    assert tm.num_vertices == 778 and np.array_equal(tm.faces, jm.faces)
    np.testing.assert_allclose(tm.vertices, jm.vertices, atol=1e-4)


def test_stages_report_missing_inputs_as_the_reference(tmp_path, capsys):
    d = _stage_inputs(str(tmp_path))
    os.remove(os.path.join(d["moge"], "000005_cropped_hoi", "mesh.ply"))
    TH2M.run(d["hunyuan"], d["moge"], d["h2m"], device="cpu")
    TMA.run(d["hamer"], str(tmp_path / "nothing"), d["aligned"], device="cpu")
    TH2M.run(str(tmp_path / "nothing"), d["moge"], d["h2m"], device="cpu")
    TMA.run(str(tmp_path / "nothing"), d["hunyuan"], d["aligned"], device="cpu")
    printed = capsys.readouterr().out
    assert "No MoGe mesh found for 000005 in" in printed
    assert "No Hunyuan mesh for 000005. Skipping." in printed
    assert "No Hunyuan HOI meshes found in" in printed
    assert "No HaMeR meshes found in" in printed
