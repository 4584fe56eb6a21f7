"""The object phase (1.5) of the PyTorch port against the JAX package: same
weights (through the bridge), same starting state, same targets, a few
optimizer steps. The models and inputs are shared with the joint-phase and
whole-run tests (``_torch_phase_models``).

The JAX side runs the package's own jitted phase; its rasterizer runs the
Pallas kernels in interpret mode, whose semantics the port's plain version
has. Both sides take the two-level in-loop decode (coarse factor 2) at an 8^3
grid.

Tolerances: float32 on both sides. An Adam(W) step is lr * m/(sqrt(v) + eps),
so a relative error in a gradient component is the same relative error of a
step of size lr; the gradients are dense pixel sums over renders in which a
few pixels are ill-conditioned in float32 (2e-2 of the largest gradient at
worst, see test_torch_rasterizer). After k steps that bounds a parameter by
k * lr * 2e-2 plus the drift it carries in. The noise prediction (lr 1e-4 in
the object phase) and the pose are held to those bounds; the measured
differences are stated beside each assertion.
"""

import dataclasses

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
    TConfig,
    TG,
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


@pytest.fixture(scope="module")
def obj_runs(models):
    jsampler, tsampler = _samplers(models, **PHASE_STEPS)
    x = _phase_inputs(11)
    sched_j = jsampler._schedule(N_SCHED)
    _, obj_phase, _, _, _ = JG._jitted_phases(jsampler)
    with _pallas_interpret_on_cpu(), jax.default_matmul_precision("highest"):
        jobj, jnoise, jl, jrend = obj_phase(
            _jpose(x["obj"]), jnp.asarray(x["noise"]), jnp.asarray(x["latents"]),
            models["vae_params"], models["jtargets"], sched_j, STEP_I)
    tobj, tnoise, tl, trend = tsampler._obj_phase(
        _tpose(x["obj"]), torch.from_numpy(x["noise"]), torch.from_numpy(x["latents"]),
        models["ttargets"], tsampler._schedule(N_SCHED), STEP_I)
    return dict(j=(_np(jobj), np.asarray(jnoise), np.asarray(jl), _np(jrend)),
                t=(tobj, tnoise, tl, trend), x=x)


def test_obj_phase_loss_curve_matches(obj_runs):
    jl, tl = obj_runs["j"][2], obj_runs["t"][2].numpy()
    assert tl.shape == (N_PHASE,) and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-3)   # measured 8e-7


def test_obj_phase_pose_and_noise_match(obj_runs):
    (jobj, jnoise, _, _), (tobj, tnoise, _, _) = obj_runs["j"], obj_runs["t"]
    # lr 1e-2: 2 steps * 1e-2 * 2e-2 = 4e-4 (measured: quat 3.3e-4, the rest <3e-5)
    for name in ("scale", "trans", "quat"):
        np.testing.assert_allclose(getattr(tobj, name).numpy(), getattr(jobj, name),
                                   atol=4e-4, err_msg=name)
    # lr 1e-4. A noise component whose gradient is below Adam's eps (1e-4)
    # steps by lr * g / eps, so an absolute gradient error d moves it by
    # lr * d / eps; d is up to 4e-5 here (float32 sums over the render), so
    # <= 0.4 lr a step: 8e-5 over two (measured 6.3e-5, of a 2e-4 move)
    np.testing.assert_allclose(tnoise.numpy(), jnoise, atol=8e-5)
    assert not np.allclose(tobj.quat.numpy(), obj_runs["x"]["obj"][2])    # the pose moved
    assert np.abs(tnoise.numpy() - obj_runs["x"]["noise"]).max() > 1.5e-4  # the noise moved


def test_obj_phase_reports_capacity_indicators(obj_runs):
    jrend, trend = obj_runs["j"][3], obj_runs["t"][3]
    assert trend["hier_cells"] == [int(c) for c in jrend["hier_cells"]]
    # a surface, and below the 64 coarse cells of the 8^3 grid (no overflow)
    assert all(0 < c < 64 for c in trend["hier_cells"])


def test_default_config_runs_every_phase():
    cfg = TConfig()
    assert (cfg.optimization_steps_hand, cfg.optimization_steps_scale,
            cfg.optimization_steps_joint) == (200, 100, 50)
    assert cfg.handopt_start_step == 9 and cfg.num_inference_steps == 20
    defaults = {f.name: f.default for f in dataclasses.fields(TG.GuidedSampler)}
    assert defaults["inloop_coarse_factor"] == 2 and defaults["inloop_cell_cap"] == 10240
    assert defaults["inloop_small_cap"] is None and defaults["vae_remat"] == "none"
