"""The joint phase (2) of the PyTorch port against the JAX package, away from
the end of the schedule and near it: same weights (through the bridge), same
starting state, same targets, a few optimizer steps. The models and inputs
are shared with the object-phase and whole-run tests (``_torch_phase_models``);
the tolerances are reasoned in test_torch_phases.py's docstring: after k
Adam(W) steps a parameter is bounded by k * lr * 2e-2 plus the drift it
carries in (the noise prediction's lr is 1e-2 in this phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_phase_models import (
    N_PHASE,
    N_SCHED,
    PHASE_STEPS,
    STEP_I,
    JG,
    _jpose,
    _np,
    _pallas_interpret_on_cpu,
    _phase_inputs,
    _samplers,
    _tpose,
    one_torch_thread,  # noqa: F401  (the module's fixture)
    phase_models,
)


@pytest.fixture(scope="module")
def models():
    return phase_models()


@pytest.fixture(scope="module", params=[False, True], ids=["early", "near_end"])
def joint_runs(models, request):
    near_end = request.param
    jsampler, tsampler = _samplers(models, **PHASE_STEPS)
    x = _phase_inputs(12)
    sched_j = jsampler._schedule(N_SCHED)
    _, _, joint_phase, _, _ = JG._jitted_phases(jsampler)
    with _pallas_interpret_on_cpu(), jax.default_matmul_precision("highest"):
        jout = joint_phase(
            _jpose(x["hand"]), _jpose(x["obj"]), jnp.asarray(x["noise"]),
            jnp.asarray(x["latents"]), models["vae_params"], models["jtargets"], sched_j,
            STEP_I, near_end=near_end)
    tout = tsampler._joint_phase(
        _tpose(x["hand"]), _tpose(x["obj"]), torch.from_numpy(x["noise"]),
        torch.from_numpy(x["latents"]), models["ttargets"], tsampler._schedule(N_SCHED),
        STEP_I, near_end=near_end)
    return dict(j=_np(jout), t=tout, x=x)


def test_joint_phase_loss_curve_matches(joint_runs):
    jl, tl = joint_runs["j"][3], joint_runs["t"][3].numpy()
    assert tl.shape == (N_PHASE,) and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-3)   # measured 8e-7


def test_joint_phase_poses_and_noise_match(joint_runs):
    (jh, jo, jn, _, _), (th, to, tn, _, _) = joint_runs["j"], joint_runs["t"]
    # bounds 2 steps * lr * 2e-2; hand lr 1e-4 (scale, trans) and 1e-2 (rot),
    # object 5e-2 (scale) and 1e-2. Measured: all below 4e-6.
    for tag, got, want, atols in (("hand", th, jh, (4e-6, 4e-6, 4e-4)),
                                  ("obj", to, jo, (2e-3, 4e-4, 4e-4))):
        for name, atol in zip(("scale", "trans", "quat"), atols):
            np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name),
                                       atol=atol, err_msg=f"{tag}.{name}")
    np.testing.assert_allclose(tn.numpy(), jn, atol=4e-4)   # lr 1e-2; measured 6.3e-6
    assert np.abs(tn.numpy() - joint_runs["x"]["noise"]).max() > 1.5e-2   # the noise moved
    assert not np.allclose(to.quat.numpy(), joint_runs["x"]["obj"][2])


def test_joint_phase_reports_capacity_indicators(joint_runs):
    jrend, trend = joint_runs["j"][4], joint_runs["t"][4]
    assert trend["hier_cells"] == [int(c) for c in jrend["hier_cells"]]
    assert all(0 < c < 64 for c in trend["hier_cells"])
    assert trend["raster_bins"] and all(
        b <= c for b, c in zip(trend["raster_bins"], trend["raster_cap"]))
