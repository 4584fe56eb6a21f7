"""The whole guided run of the PyTorch port against the JAX package's ``run``:
hand -> object -> joint x4, on the same weights (through the bridge), the same
initial noise and the same targets. The models are shared with the object- and
joint-phase tests (``_torch_phase_models``), whose docstrings reason the
tolerances; a run chains every phase, so its bounds add the drift each phase
carries into the next.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_phase_models import (
    N_SCHED,
    _np,
    _pallas_interpret_on_cpu,
    _samplers,
    one_torch_thread,  # noqa: F401  (the module's fixture)
    phase_models,
)


@pytest.fixture(scope="module")
def models():
    return phase_models()


# --------------------------------------------------------------------------- #
# the whole run: hand -> object -> joint x4 (one of them away from the end)
# --------------------------------------------------------------------------- #

# One step a phase. Each phase's first Adam step moves a component by about
# lr * sign(g); over a chain of phases a component whose gradient lies within
# rounding of zero, or a pixel or mesh vertex that the two sides put on either
# side of an edge, can send the trajectories apart, so longer runs are held to
# the phase tests above.
RUN_STEPS = dict(num_inference_steps=N_SCHED, optimization_steps_hand=1,
                 optimization_steps_scale=1, optimization_steps_joint=1)


@pytest.fixture(scope="module")
def whole_runs(models):
    jsampler, tsampler = _samplers(models, **RUN_STEPS)
    rng = np.random.default_rng(13)
    cond = rng.normal(size=(1, 4, 32)).astype(np.float32)
    key = jax.random.key(5)
    noise = np.asarray(jax.random.normal(key, (1, 16, 8), jnp.float32))
    with _pallas_interpret_on_cpu(), jax.default_matmul_precision("highest"):
        jres = jsampler.run(models["dit_params"], models["vae_params"], jnp.asarray(cond),
                            jnp.zeros_like(jnp.asarray(cond)), models["jtargets"], key,
                            (16, 8))
    tres = tsampler.run(torch.from_numpy(cond), torch.zeros(cond.shape), models["ttargets"],
                        (16, 8), initial_noise=torch.from_numpy(noise), device="cpu")
    return dict(j=_np(jres), t=tres)


def test_whole_run_phases_and_loss_curves_match(whole_runs):
    j, t = whole_runs["j"], whole_runs["t"]
    assert sorted(t.losses) == sorted(j.losses) == sorted(
        ["hand", "obj", "joint_6", "joint_7", "joint_8", "joint_9"])
    for tag, want in j.losses.items():
        got = t.losses[tag].numpy()
        assert got.shape == want.shape == (1,) and np.isfinite(got).all(), tag
        # measured 1.2e-3 at joint_8: the losses carry the drift of the
        # states below
        np.testing.assert_allclose(got, want, rtol=5e-3, err_msg=tag)
    seconds = t.seconds
    assert len(seconds["dit_steps"]) == N_SCHED
    assert seconds["hand"] > 0 and seconds["obj"] > 0 and seconds["joint"] > 0


def test_whole_run_final_state_matches(whole_runs):
    j, t = whole_runs["j"], whole_runs["t"]
    # the noise takes four joint steps at lr 1e-2 and the latents follow it
    # through the scheduler: 5e-3, half a step (measured 1.8e-3 and 2.1e-3)
    np.testing.assert_allclose(t.noise_pred.numpy(), j.noise_pred, atol=5e-3)
    np.testing.assert_allclose(t.latents.numpy(), j.latents, atol=5e-3)
    # the hand: one phase-1 step (lr 0.5 on the rotation) then four at 1e-4 /
    # 1e-2; 1e-3 (measured 2.9e-5)
    for name in ("scale", "trans", "quat"):
        np.testing.assert_allclose(getattr(t.hand, name).numpy(), getattr(j.hand, name),
                                   atol=1e-3, err_msg=f"hand.{name}")
    # the object: five steps of 1e-2 on translation and rotation, where one
    # component stepping the other way costs 2e-2 (measured once: 2.0e-2);
    # scale 5e-2 a step (measured 8e-7)
    for name, atol in (("scale", 5e-2), ("trans", 2.5e-2), ("quat", 2.5e-2)):
        np.testing.assert_allclose(getattr(t.obj, name).numpy(), getattr(j.obj, name),
                                   atol=atol, err_msg=f"obj.{name}")
    assert not np.allclose(t.obj.quat.numpy(), [1, 0, 0, 0])     # the object pose moved
