"""Geometry of the PyTorch port against the JAX package on the same numpy
inputs: rotations, transforms, camera, grid, losses, MANO keypoints, scheduler.

Tolerance 1e-6 (absolute, values of order one): both sides are float32 and do
the same operations; sums may be taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followmyhold_tpu.diffusion import scheduler as jsched
from followmyhold_tpu.models import mano as jmano
from followmyhold_tpu.ops import camera as jcam
from followmyhold_tpu.ops import grid as jgrid
from followmyhold_tpu.ops import losses as jloss
from followmyhold_tpu.ops import rotations as jrot
from followmyhold_tpu.ops import safe as jsafe
from followmyhold_tpu.ops import transforms as jtf
from followmyhold_tpu_torch.diffusion import scheduler as tsched
from followmyhold_tpu_torch.models import mano as tmano
from followmyhold_tpu_torch.ops import camera as tcam
from followmyhold_tpu_torch.ops import grid as tgrid
from followmyhold_tpu_torch.ops import losses as tloss
from followmyhold_tpu_torch.ops import rotations as trot
from followmyhold_tpu_torch.ops import safe as tsafe
from followmyhold_tpu_torch.ops import transforms as ttf

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=1e-6)


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_quaternion_to_matrix_matches():
    q = _rng(1).normal(size=(6, 4)).astype(np.float32) * 3.0
    _close(trot.quaternion_to_matrix(_t(q)), jrot.quaternion_to_matrix(jnp.asarray(q)))


def test_rt_from_quat_trans_matches():
    r = _rng(2)
    q, t = r.normal(size=4).astype(np.float32), r.normal(size=3).astype(np.float32)
    _close(ttf.rt_from_quat_trans(_t(q), _t(t)),
           jtf.rt_from_quat_trans(jnp.asarray(q), jnp.asarray(t)))


def test_transform_points_matches():
    r = _rng(3)
    p = r.normal(size=(50, 3)).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :] = r.normal(size=(3, 4))
    _close(ttf.transform_points(_t(p), _t(T)),
           jtf.transform_points(jnp.asarray(p), jnp.asarray(T)), atol=2e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_masked_bbox_center_and_similarity_transform_match(masked):
    r = _rng(4)
    v = r.normal(size=(40, 3)).astype(np.float32)
    mask = (r.uniform(size=40) > 0.3).astype(np.float32) if masked else None
    q, t = r.normal(size=4).astype(np.float32), r.normal(size=3).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    _close(ttf.masked_bbox_center(_t(v), tm), jtf.masked_bbox_center(jnp.asarray(v), jm))
    jT = jtf.rt_from_quat_trans(jnp.asarray(q), jnp.asarray(t))
    tT = ttf.rt_from_quat_trans(_t(q), _t(t))
    _close(ttf.transform_around_center_w_scale(_t(v), tT, torch.tensor(1.3), tm),
           jtf.transform_around_center_w_scale(jnp.asarray(v), jT, jnp.asarray(1.3), jm),
           atol=2e-6)


@pytest.mark.parametrize("fov", [None, 47.5])
def test_camera_project_matches(fov):
    r = _rng(5)
    p = r.normal(size=(30, 3)).astype(np.float32)
    p[:, 2] = -np.abs(p[:, 2]) - 0.5
    p[0, 2] = 0.3  # behind the camera: the clamp at 1e-6 must agree too
    jc = jcam.GuidanceCamera(height=96, width=128, fov_deg=60.0)
    tc = tcam.GuidanceCamera(height=96, width=128, fov_deg=60.0)
    assert abs(jc.focal_px - tc.focal_px) < 1e-9
    want = jc.project(jnp.asarray(p), fov_deg=None if fov is None else jnp.asarray(fov))
    got = tc.project(_t(p), fov_deg=None if fov is None else torch.tensor(fov))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=1e-4)


def test_dense_grid_matches():
    jx, jn, jl = jgrid.generate_dense_grid_points([-1.1] * 3, [1.1] * 3, 6)
    tx, tn, tl = tgrid.generate_dense_grid_points([-1.1] * 3, [1.1] * 3, 6, device="cpu")
    assert tuple(tn) == tuple(jn)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def _loss_inputs():
    r = _rng(6)
    return dict(
        a3=r.normal(size=(12, 10, 3)).astype(np.float32),
        b3=r.normal(size=(12, 10, 3)).astype(np.float32),
        a=r.uniform(size=(12, 10)).astype(np.float32),
        b=r.uniform(size=(12, 10)).astype(np.float32),
        m=(r.uniform(size=(12, 10)) > 0.5),
        sdf_h=r.normal(size=200).astype(np.float32),
        sdf_o=r.normal(size=200).astype(np.float32),
        d2=r.uniform(0, 0.05, size=64).astype(np.float32),
        dm=(r.uniform(size=64) > 0.4),
        verts=r.normal(size=(20, 3)).astype(np.float32),
        edges=r.integers(0, 20, size=(33, 2)).astype(np.int32),
        em=(r.uniform(size=33) > 0.3).astype(np.float32),
        vm=(r.uniform(size=20) > 0.3).astype(np.float32),
    )


def _port_loss(name, *args):
    """The port's loss on one image: the guidance losses take a batch and
    return an unreduced Mean, so they get a batch of one, reduced."""
    if name in ("honerf_intersection_loss", "soft_intersection_loss"):
        return getattr(tloss, name)(*args)
    return tloss.image_means(getattr(tloss, name)(*(x[None] for x in args)))[0][0]


LOSS_CASES = {
    "normal_alignment": ("normal_alignment_loss", ["a3", "b3"]),
    "normal_alignment_masked": ("normal_alignment_loss", ["a3", "b3", "m"]),
    "masked_l1": ("masked_l1", ["a", "b"]),
    "masked_l1_masked": ("masked_l1", ["a", "b", "m"]),
    "mse": ("mse", ["a", "b"]),
    "bce": ("binary_cross_entropy", ["a", "m"]),
    "honerf": ("honerf_intersection_loss", ["sdf_h", "sdf_o"]),
    "soft_intersection": ("soft_intersection_loss", ["sdf_h", "sdf_o"]),
    "attraction": ("attraction_loss", ["d2"]),
    "mesh_edge": ("mesh_edge_loss", ["verts", "edges"]),
    "mesh_edge_masked": ("mesh_edge_loss", ["verts", "edges", "em"]),
    "verts_reg": ("verts_reg_loss", ["verts"]),
    "verts_reg_masked": ("verts_reg_loss", ["verts", "vm"]),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_matches(case):
    name, keys = LOSS_CASES[case]
    data = _loss_inputs()
    want = getattr(jloss, name)(*(jnp.asarray(data[k]) for k in keys))
    targs = [_t(data[k]).long() if k == "edges" else _t(data[k]) for k in keys]
    _close(_port_loss(name, *targs), want)


def test_attraction_loss_mask_and_combine_match():
    data = _loss_inputs()
    want = jloss.attraction_loss(jnp.asarray(data["d2"]), 0.01, jnp.asarray(data["dm"]))
    got = tloss.image_means(tloss.attraction_loss(_t(data["d2"])[None], 0.01,
                                                  _t(data["dm"])[None]))[0][0]
    _close(got, want)
    terms = {"a": np.float32(1.5), "b": np.float32(np.nan), "c": np.float32(-2.0)}
    weights = {"a": 2.0, "c": 0.5}
    want = jloss.combine_losses_fp32({k: jnp.asarray(v) for k, v in terms.items()}, weights)
    got = tloss.combine_losses_fp32({k: torch.tensor(v) for k, v in terms.items()}, weights)
    _close(got, want)


def test_safe_norms_match_values_and_gradients_at_zero():
    x = _rng(7).normal(size=(5, 3)).astype(np.float32)
    x[2] = 0.0
    _close(tsafe.safe_norm(_t(x)), jsafe.safe_norm(jnp.asarray(x)))
    _close(tsafe.safe_normalize(_t(x)), jsafe.safe_normalize(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    (tsafe.safe_norm(xt).sum() + tsafe.safe_normalize(xt).sum()).backward()
    want = jax.grad(lambda a: jsafe.safe_norm(a).sum() + jsafe.safe_normalize(a).sum())(
        jnp.asarray(x))
    assert torch.isfinite(xt.grad).all()
    _close(xt.grad, want, atol=2e-6)


def test_synthetic_mano_is_the_same_model():
    jm, tm = jmano.synthetic_mano(), tmano.synthetic_mano(device="cpu")
    for field in jm._fields:
        np.testing.assert_array_equal(getattr(tm, field).numpy(), np.asarray(getattr(jm, field)),
                                      err_msg=field)


def test_mano_vert_to_3dkps_matches():
    jm = jmano.synthetic_mano()
    v = np.asarray(jm.v_template) + _rng(8).normal(scale=0.01, size=(778, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jmano.mano_vert_to_3dkps(jnp.asarray(v), jm.j_regressor)
    got = tmano.mano_vert_to_3dkps(_t(v), _t(np.asarray(jm.j_regressor)))
    assert got.shape == (21, 3)
    _close(got, want)


@pytest.mark.parametrize("shift", [1.0, 3.0])
def test_schedule_from_given_sigmas_matches(shift):
    js = jsched.make_schedule(sigmas=np.linspace(0, 1, 20), shift=shift)
    ts = tsched.make_schedule(sigmas=np.linspace(0, 1, 20), shift=shift)
    np.testing.assert_array_equal(np.float32(ts.sigmas), np.asarray(js.sigmas))
    np.testing.assert_array_equal(np.float32(ts.timesteps), np.asarray(js.timesteps))
    assert ts.num_train_timesteps == js.num_train_timesteps


def test_default_schedule_matches():
    js = jsched.make_schedule(num_inference_steps=7, shift=2.0)
    ts = tsched.make_schedule(num_inference_steps=7, shift=2.0)
    np.testing.assert_array_equal(np.float32(ts.sigmas), np.asarray(js.sigmas))


@pytest.mark.parametrize("index", [0, 7, 19])
def test_scheduler_steps_match(index):
    r = _rng(9)
    x = r.normal(size=(1, 16, 8)).astype(np.float32)
    eps = r.normal(size=(1, 16, 8)).astype(np.float32)
    js = jsched.make_schedule(sigmas=np.linspace(0, 1, 20))
    ts = tsched.make_schedule(sigmas=np.linspace(0, 1, 20))
    jprev, jx1 = jsched.step(js, index, jnp.asarray(eps), jnp.asarray(x))
    tprev, tx1 = tsched.step(ts, index, _t(eps), _t(x))
    _close(tprev, jprev)
    _close(tx1, jx1)
    _close(tsched.step_final(ts, index, _t(eps), _t(x)),
           jsched.step_final(js, index, jnp.asarray(eps), jnp.asarray(x)))
    _close(tsched.scale_noise(ts, index, _t(x), _t(eps)),
           jsched.scale_noise(js, index, jnp.asarray(x), jnp.asarray(eps)))
