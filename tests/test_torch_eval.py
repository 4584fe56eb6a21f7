"""Evaluation in the PyTorch port against the JAX package: the signed
distances of ``ops/sdf.py`` (Ericson's closest point, ``mesh_to_sdf``,
``shared_grid_sdfs``), every metric of ``eval/metrics.py``, and
``eval/run.evaluate`` in both of its modes.

Tolerances, float32 on both sides (measured on the CPU with these seeds):
- the squared point-triangle distances and the signed distances: 1e-5 of the
  largest |entry| (measured <= 7.1e-8 of it); the signs equal wherever the
  reference's |SDF| exceeds 1e-3 (the winding number's 0.5 is far from both
  0 and 1 there);
- the metrics and the report: 1e-6, absolute on values of order 1 or less
  (measured <= 3.0e-7; the sums run in another order).
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followmyhold_tpu.eval import metrics as JE
from followmyhold_tpu.eval import run as JR
from followmyhold_tpu.ops import sdf as JS
from followmyhold_tpu.utils.mesh_io import write_ply
from followmyhold_tpu_torch.eval import metrics as TE
from followmyhold_tpu_torch.eval import run as TR
from followmyhold_tpu_torch.ops import sdf as TS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _sphere(radius, n=16, center=(0.0, 0.0, 0.0)):
    """A closed UV sphere wound outward: [V,3] float32, [F,3] int32."""
    theta = np.linspace(0, np.pi, n)[1:-1]
    phi = np.linspace(0, 2 * np.pi, n, endpoint=False)
    T, P = np.meshgrid(theta, phi, indexing="ij")
    ring = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 0, 1]], ring, [[0, 0, -1]]]) * radius + np.asarray(center)
    rows, top, bottom = len(theta), 0, 1 + len(theta) * n
    faces = [[top, 1 + (j + 1) % n, 1 + j] for j in range(n)]
    for i in range(rows - 1):
        for j in range(n):
            a, b = 1 + i * n + j, 1 + i * n + (j + 1) % n
            c, d = a + n, b + n
            faces += [[a, b, c], [b, d, c]]
    last = 1 + (rows - 1) * n
    faces += [[bottom, last + j, last + (j + 1) % n] for j in range(n)]
    return verts.astype(np.float32), np.asarray(faces, np.int32)[:, ::-1].copy()


def test_point_triangle_sqdist_matches_the_reference():
    rng = np.random.default_rng(0)
    tri = rng.normal(size=(40, 3, 3)).astype(np.float32)
    tri[3, 2] = tri[3, 0]                                     # a degenerate triangle
    tri[5] = tri[5, 0]                                        # a point triangle
    pts = np.concatenate([rng.normal(size=(200, 3)), tri[:8, 1],          # at vertices
                          tri[:8].mean(1)]).astype(np.float32)           # on faces
    want = np.asarray(jax.jit(JS.point_triangle_sqdist)(jnp.asarray(pts), jnp.asarray(tri)))
    got = TS.point_triangle_sqdist(_t(pts), _t(tri)).numpy()
    assert got.shape == (216, 40) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # brute force: the closest of many points spread over each triangle
    u, v = np.meshgrid(np.linspace(0, 1, 41), np.linspace(0, 1, 41))
    keep = (u + v) <= 1
    bary = np.stack([1 - u[keep] - v[keep], u[keep], v[keep]], -1)
    samples = np.einsum("sk,fkc->fsc", bary, tri)
    brute = ((pts[:, None, None] - samples[None]) ** 2).sum(-1).min(-1)
    assert (got <= brute + 1e-5).all() and (brute - got).max() < 0.05


def test_mesh_to_sdf_matches_the_reference_in_chunks():
    verts, faces = _sphere(0.5)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.8, 0.8, (3000, 3)).astype(np.float32)   # two chunks of 2,048
    mask = np.ones(len(faces), np.float32)
    mask[::7] = 0.0
    for face_mask in (None, mask):
        fm = None if face_mask is None else jnp.asarray(face_mask)
        want = np.asarray(jax.jit(JS.mesh_to_sdf)(jnp.asarray(pts), jnp.asarray(verts),
                                                  jnp.asarray(faces), fm))
        got = TS.mesh_to_sdf(_t(pts), _t(verts), _t(faces).long(),
                             None if face_mask is None else _t(face_mask)).numpy()
        assert got.shape == (3000,)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        far = np.abs(want) > 1e-3
        np.testing.assert_array_equal(np.sign(got[far]), np.sign(want[far]))
    radius = np.linalg.norm(pts, axis=-1)
    assert (got[radius < 0.4] < 0).all() and (got[radius > 0.6] > 0).all()


def test_shared_grid_sdfs_match_the_reference():
    v1, f1 = _sphere(0.3)
    v2, f2 = _sphere(0.2, n=12, center=(0.25, 0.0, 0.1))
    # padded buffers: masked vertices far away, masked faces at the end
    v1p = np.concatenate([v1, [[9.0, 9.0, 9.0]]]).astype(np.float32)
    f1p = np.concatenate([f1, [[0, 1, len(v1)]]]).astype(np.int32)
    vm1 = np.ones(len(v1p), np.float32)
    vm1[-1] = 0
    fm1 = np.ones(len(f1p), np.float32)
    fm1[-1] = 0
    args = [(v1p, f1p, fm1), (v2, f2, None)]
    shared = jax.jit(JS.shared_grid_sdfs, static_argnames="resolution")
    want = shared(*(jnp.asarray(a) if a is not None else None for trio in args for a in trio),
                  vert_mask1=jnp.asarray(vm1), resolution=8)
    got = TS.shared_grid_sdfs(_t(v1p), _t(f1p).long(), _t(fm1), _t(v2), _t(f2).long(), None,
                              vert_mask1=_t(vm1), resolution=8)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (9 ** 3,)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    assert (got[0] < 0).any() and (got[1] < 0).any()


def _depths(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32)
    pred = (1.7 * gt * rng.uniform(0.8, 1.25, gt.shape)).astype(np.float32)
    pred[0, :4] = 0.0                               # the clamps' branches
    mask = rng.uniform(size=gt.shape) > 0.3
    return pred, gt, mask


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_depth_metrics_match_the_reference(masked):
    pred, gt, mask = _depths(2)
    m = (mask,) if masked else (None,)
    for name in ("align_depth_scale", "rel_depth", "delta1_depth"):
        want = float(getattr(JE, name)(jnp.asarray(pred), jnp.asarray(gt),
                                       *(jnp.asarray(x) if x is not None else None for x in m)))
        got = getattr(TE, name)(_t(pred), _t(gt), *(_t(x) if x is not None else None for x in m))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want)), name
    want = JE.scale_aligned_depth_metrics(jnp.asarray(pred), jnp.asarray(gt),
                                          jnp.asarray(mask) if masked else None)
    got = TE.scale_aligned_depth_metrics(_t(pred), _t(gt), _t(mask) if masked else None)
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], atol=1e-6)
    assert 0.0 < float(got[1]) <= 1.0


def test_chamfer_f_score_and_mesh_chamfer_match_the_reference():
    rng = np.random.default_rng(3)
    a = rng.normal(scale=0.1, size=(300, 3)).astype(np.float32)
    b = (a[:250] + rng.normal(scale=0.004, size=(250, 3))).astype(np.float32)
    am = rng.uniform(size=300) > 0.2
    bm = rng.uniform(size=250) > 0.2
    for masks in ((None, None), (am, bm)):
        want = float(JE.chamfer_distance(jnp.asarray(a), jnp.asarray(b),
                                         *(None if m is None else jnp.asarray(m) for m in masks)))
        got = float(TE.chamfer_distance(_t(a), _t(b),
                                        *(None if m is None else _t(m) for m in masks)))
        assert abs(got - want) <= 1e-6, (got, want)
    for thresh in (0.005, 0.01, 0.05):
        want = float(JE.f_score(jnp.asarray(a), jnp.asarray(b), threshold=thresh))
        got = float(TE.f_score(_t(a), _t(b), threshold=thresh))
        assert abs(got - want) <= 1e-6, (thresh, got, want)
    v1, f1 = _sphere(0.1)
    v2, f2 = _sphere(0.104)
    want = JE.chamfer_between_meshes(v1, f1, v2, f2, samples=1500, seed=4)
    got = TE.chamfer_between_meshes(v1, f1, v2, f2, samples=1500, seed=4, device="cpu")
    assert abs(got - want) <= 1e-6 and 0.002 < got < 0.009


def _split(tmp_path, ids):
    split = tmp_path / "split.csv"
    with open(split, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["img_id", "img_path"])
        w.writeheader()
        w.writerows({"img_id": i, "img_path": f"imgs/{i}.png"} for i in ids)
    return str(split)


def test_evaluate_matches_the_reference_report(tmp_path):
    """Two scored rows, one without a reference, one without a prediction,
    one degenerate mesh: the same report JSON to 1e-6."""
    pred_dir, ref_dir = tmp_path / "pred", tmp_path / "ref"
    pred_dir.mkdir()
    ref_dir.mkdir()
    for i, img_id in enumerate(("000001", "000002", "000003", "000004")):
        v, f = _sphere(0.1 + 0.01 * i)
        write_ply(str(pred_dir / f"{img_id}_obj.ply"), v, f)
        if img_id != "000003":
            vr, fr = _sphere(0.104 + 0.01 * i, n=12)
            write_ply(str(ref_dir / f"{img_id}_obj.ply"), vr, fr if img_id != "000004"
                      else np.zeros((0, 3), np.int32))
    split = _split(tmp_path, ["000001", "000002", "000003", "000004", "000099"])
    assert TR.read_split(split) == JR.read_split(split)
    want = JR.evaluate(split, str(pred_dir), str(ref_dir), samples=800,
                       report_path=str(tmp_path / "want.json"))
    got = TR.evaluate(split, str(pred_dir), str(ref_dir), samples=800,
                      report_path=str(tmp_path / "got.json"), device="cpu")
    with open(tmp_path / "got.json") as f:
        assert json.load(f) == got
    assert set(got["per_image"]) == set(want["per_image"]) == {"000001", "000002", "000004"}
    assert "error" in got["per_image"]["000004"] and "error" in want["per_image"]["000004"]
    s, w = got["summary"], want["summary"]
    assert sorted(s) == sorted(w) and s["evaluated"] == 2 and s["missing_ref"] == 1
    for key in w:
        if isinstance(w[key], float):
            assert abs(s[key] - w[key]) <= 1e-6, key
        else:
            assert s[key] == w[key], key
    for img_id in ("000001", "000002"):
        for key, value in want["per_image"][img_id].items():
            assert abs(got["per_image"][img_id][key] - value) <= 1e-6, (img_id, key)
    # without a reference directory: the exports counted
    only = TR.evaluate(split, str(pred_dir), device="cpu")
    assert only == JR.evaluate(split, str(pred_dir))


def test_evaluate_runs_the_pipeline_for_missing_rows(tmp_path, monkeypatch):
    """--base_dir: one env file a missing row (the reference's keys and
    values), the port's run_pipeline on the given device, a failing row
    reported with its traceback and the next one run."""
    import followmyhold_tpu.main as jmain
    import followmyhold_tpu_torch.main as tmain

    img_root = tmp_path / "root"
    (img_root / "imgs").mkdir(parents=True)
    for img_id in ("000001", "000002"):
        (img_root / "imgs" / f"{img_id}.png").write_bytes(b"png")
    split = _split(tmp_path, ["000001", "000002", "000003"])
    calls = {"jax": [], "torch": []}

    def stub(key):
        def run_pipeline(cfg, device=None):
            calls[key].append((cfg.image_path, cfg.base_dir, cfg.run_inpaint, device))
            if cfg.image_path.endswith("000001.png"):
                raise RuntimeError("stage failed")
        return run_pipeline

    monkeypatch.setattr(jmain, "run_pipeline", stub("jax"))
    monkeypatch.setattr(tmain, "run_pipeline", stub("torch"))
    envs = {}
    for key, evaluate in (("jax", JR.evaluate), ("torch", TR.evaluate)):
        base = tmp_path / key
        base.mkdir()
        kw = {"device": "cpu"} if key == "torch" else {}
        evaluate(split, str(tmp_path / "pred"), base_dir=str(base), image_root=str(img_root), **kw)
        envs[key] = {f: (base / f).read_text().replace(str(base), "<base>")
                     for f in sorted(os.listdir(base))}
    assert envs["torch"] == envs["jax"] and len(envs["torch"]) == 2
    assert [c[:3] for c in calls["torch"]] == [
        (c[0], c[1].replace(str(tmp_path / "jax"), str(tmp_path / "torch")), c[2])
        for c in calls["jax"]]
    assert [c[3] for c in calls["torch"]] == [torch.device("cpu")] * 2
