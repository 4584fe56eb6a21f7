"""The joint phase's geometry in the PyTorch port against the JAX package on
the same numpy inputs: nearest neighbours, the generalized winding number, the
grid over a tensor bbox and the hand-object intersection count.

Tolerances: distances and the grid to 1e-6 (float32, the same operations);
the winding number to 1e-5 (a sum of 1,538 solid angles in another order);
indices and counts exactly, on inputs without ties or points within rounding
of a surface.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followmyhold_tpu.diffusion import guidance as JG
from followmyhold_tpu.models.mano import synthetic_mano as j_synthetic_mano
from followmyhold_tpu.ops import grid as jgrid
from followmyhold_tpu.ops import knn as jknn
from followmyhold_tpu.ops import sdf as jsdf
from followmyhold_tpu.ops.surface import marching_tets as j_marching_tets
from followmyhold_tpu_torch.diffusion import guidance as TG
from followmyhold_tpu_torch.ops import grid as tgrid
from followmyhold_tpu_torch.ops import knn as tknn
from followmyhold_tpu_torch.ops import sdf as tsdf
from followmyhold_tpu_torch.ops.surface import marching_tets as t_marching_tets


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _points(seed, n):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [4096, 7], ids=["one_chunk", "chunked"])
def test_nn_sqdist_matches(masked, chunk):
    q, p = _points(0, 40), _points(1, 60)
    mask = (np.arange(60) % 3 != 0).astype(np.float32) if masked else None
    jd, ji = jknn.nn_sqdist(jnp.asarray(q), jnp.asarray(p),
                            None if mask is None else jnp.asarray(mask), chunk=chunk)
    td, ti = tknn.nn_sqdist(_t(q), _t(p), None if mask is None else _t(mask), chunk=chunk)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_nn_sqdist_gradient_flows_to_the_queries_only():
    q, p = _points(2, 10), _points(3, 20)
    tq = _t(q).requires_grad_(True)
    d, _ = tknn.nn_sqdist(tq, _t(p))
    d.sum().backward()
    jg = jax.grad(lambda a: jknn.nn_sqdist(a, jnp.asarray(p))[0].sum())(jnp.asarray(q))
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jg), atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_knn_matches(masked):
    q, p = _points(4, 30), _points(5, 50)
    mask = (np.arange(50) % 4 != 1).astype(np.float32) if masked else None
    jd, ji = jknn.knn(jnp.asarray(q), jnp.asarray(p), 5,
                      None if mask is None else jnp.asarray(mask))
    td, ti = tknn.knn(_t(q), _t(p), 5, None if mask is None else _t(mask))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("masked", [False, True])
def test_winding_number_matches_on_the_hand_mesh(masked):
    mano = j_synthetic_mano()
    verts = np.asarray(mano.v_template)
    faces = np.asarray(mano.faces)
    lo, hi = verts.min(0), verts.max(0)
    pts = np.random.default_rng(6).uniform(lo - 0.01, hi + 0.01, (300, 3)).astype(np.float32)
    fmask = (np.arange(len(faces)) % 5 != 0).astype(np.float32) if masked else None
    want = jsdf.winding_number(jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(faces),
                               None if fmask is None else jnp.asarray(fmask))
    got = tsdf.winding_number(_t(pts), _t(verts), _t(faces).long(),
                              None if fmask is None else _t(fmask), chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if not masked:   # a closed mesh: some points inside, some outside
        inside = got.numpy() > 0.5
        assert 0 < inside.sum() < len(pts)


def test_generate_grid_matches():
    lo, hi = np.float32([-0.3, -0.1, -0.9]), np.float32([0.2, 0.4, -0.5])
    want = jgrid.generate_grid_jax(jnp.asarray(lo), jnp.asarray(hi), 6)
    got = tgrid.generate_grid(_t(lo), _t(hi), 6)
    assert got.shape == (343, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_intersection_count_matches():
    """A sphere object overlapping the hand: the count of grid points inside
    both, from the decoded grid (trilinear) and the hand's winding number."""
    res, box = 16, 1.1
    mano = j_synthetic_mano()
    hand = np.asarray(mano.v_template)
    hand = (hand - hand.mean(0) + np.float32([0, 0, -0.8])).astype(np.float32)
    faces = np.asarray(mano.faces)
    t_h2m = np.eye(4, dtype=np.float32)
    t_h2m[:3, :3] *= 0.25
    t_h2m[2, 3] = -0.8
    xyz = np.asarray(jgrid.generate_dense_grid_points([-box] * 3, [box] * 3, res)[0])
    sdf = (np.linalg.norm(xyz - np.float32([0.1, 0.0, 0.0]), axis=-1) - 0.3).astype(np.float32)
    bbox = (np.float32([-box] * 3), np.float32([box] * 3))
    pose = (np.float32([1.1]), np.float32([0.01, -0.02, 0.0]),
            np.float32([0.98, 0.1, -0.05, 0.02]))
    jmesh = j_marching_tets(jnp.asarray(sdf), jnp.asarray(bbox[0]), jnp.asarray(bbox[1]), res,
                            max_verts=4096, max_faces=8192)
    tmesh = t_marching_tets(_t(sdf), _t(bbox[0]), _t(bbox[1]), res, max_verts=4096,
                            max_faces=8192)
    tg = dict(mano_verts_moge=hand, mano_faces=faces, j_regressor=np.zeros((21, 778), np.float32),
              hamer_2d_kps=np.zeros((21, 2), np.float32),
              moge_normal=np.zeros((4, 4, 3), np.float32), moge_disp=np.zeros((4, 4), np.float32),
              hand_mask=np.zeros((4, 4), bool), obj_mask=np.zeros((4, 4), bool), t_h2m=t_h2m)
    jtargets = JG.GuidanceTargets(**{k: jnp.asarray(v) for k, v in tg.items()})
    ttargets = TG.GuidanceTargets(**{k: _t(v).long() if k == "mano_faces" else _t(v)
                                     for k, v in tg.items()})
    jpose = JG.PoseParams(*(jnp.asarray(x) for x in pose))
    tpose = TG.PoseParams(*(_t(x) for x in pose))
    jposed = JG._transform_object(jmesh, jtargets, jpose).verts
    tposed = TG._transform_object(tmesh, ttargets, tpose).verts
    want = JG._intersection_count(jnp.asarray(hand), jnp.asarray(faces), jmesh, jposed,
                                  jnp.asarray(sdf), (jnp.asarray(bbox[0]), jnp.asarray(bbox[1])),
                                  res, jtargets, jpose, sample_res=12)
    got = TG._intersection_count(_t(hand), _t(faces).long(), tmesh, tposed, _t(sdf),
                                 (_t(bbox[0]), _t(bbox[1])), res, ttargets, tpose, sample_res=12)
    assert float(want) > 0            # the meshes do overlap
    assert float(got) == float(want)
