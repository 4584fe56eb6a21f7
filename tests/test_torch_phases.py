"""The object phase (1.5), the joint phase (2) and the whole guided run of the
PyTorch port against the JAX package: same weights (through the bridge), same
starting state, same targets, a few optimizer steps each.

The JAX side runs the package's own jitted phases and its ``run``; its
rasterizer runs the Pallas kernels in interpret mode, whose semantics the
port's plain version has. Both sides take the two-level in-loop decode
(coarse factor 2) at an 8^3 grid.

Tolerances: float32 on both sides. An Adam(W) step is lr * m/(sqrt(v) + eps),
so a relative error in a gradient component is the same relative error of a
step of size lr; the gradients are dense pixel sums over renders in which a
few pixels are ill-conditioned in float32 (2e-2 of the largest gradient at
worst, see test_torch_rasterizer). After k steps that bounds a parameter by
k * lr * 2e-2 plus the drift it carries in. The noise prediction (lr 1e-4 in
the object phase, 1e-2 in the joint phase) and the poses are held to those
bounds; the measured differences are stated beside each assertion.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followmyhold_tpu.configs.guidance import OptimizationConfig as JConfig
from followmyhold_tpu.diffusion import guidance as JG
from followmyhold_tpu.models import hunyuan as JH
from followmyhold_tpu.ops.camera import GuidanceCamera as JCamera
from followmyhold_tpu_torch.configs.guidance import OptimizationConfig as TConfig
from followmyhold_tpu_torch.diffusion import guidance as TG
from followmyhold_tpu_torch.models import hunyuan as TH
from followmyhold_tpu_torch.ops.camera import GuidanceCamera as TCamera
from followmyhold_tpu_torch.utils.params import flax_to_torch
from test_torch_guidance import CAPS, RES, SIZE, _numpy_targets, _pallas_interpret_on_cpu

# the object meshes here carry ~2,400 faces, all in the one 128x128 tile: a
# capacity above that keeps both rasterizers below their caps
PHASE_CAPS = dict(CAPS, raster_faces_per_tile=8192)

DIT_KW = dict(in_channels=8, hidden=64, heads=4, depth_double=1, depth_single=1,
              context_dim=32, time_dim=32)
VAE_KW = dict(num_latents=16, embed_dim=8, width=32, heads=4, depth=1, geo_heads=4)
N_PHASE = 2          # optimizer steps of each phase test
STEP_I = 6           # the schedule step the phases decode at (of N_SCHED)
N_SCHED = 10
# one sampler for both phase tests, so that each side compiles/builds it once
PHASE_STEPS = dict(num_inference_steps=N_SCHED, optimization_steps_hand=1,
                   optimization_steps_scale=N_PHASE, optimization_steps_joint=N_PHASE)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _smooth_field(vae_params):
    """Keep only the lowest Fourier frequency of the geo decoder's query
    embedding: random weights then decode a smooth field whose surface crosses
    ~40 of the 64 coarse cells, below every capacity, where the full embedding
    (frequencies up to 2^7) decodes noise that overflows them."""
    params = _np(vae_params)
    kernel = params["params"]["geo"]["query_in"]["kernel"].copy()   # [3 * 17, width]
    keep = np.zeros(kernel.shape[0], bool)
    keep[[c * 17 + j for c in range(3) for j in (0, 1, 9)]] = True   # x, sin x, cos x
    kernel[~keep] = 0.0
    params["params"]["geo"]["query_in"]["kernel"] = kernel
    return params


@pytest.fixture(scope="module")
def models():
    jdit = JH.HunyuanDiT(JH.DiTConfig(dtype=jnp.float32, **DIT_KW))
    jvae = JH.ShapeVAE(JH.ShapeVAEConfig(dtype=jnp.float32, **VAE_KW))
    key = jax.random.key(0)
    dit_params = jdit.init(key, jnp.zeros((1, 16, 8)), jnp.zeros(1), jnp.zeros((1, 4, 32)))
    vae_params = _smooth_field(jvae.init(key, jnp.zeros((1, 16, 8)), jnp.zeros((1, 8, 3))))
    tdit = flax_to_torch(_np(dit_params), TH.HunyuanDiT(
        TH.DiTConfig(dtype=torch.float32, **DIT_KW))).eval().requires_grad_(False)
    tvae = flax_to_torch(_np(vae_params), TH.ShapeVAE(
        TH.ShapeVAEConfig(dtype=torch.float32, **VAE_KW))).eval().requires_grad_(False)
    tg = _numpy_targets()
    return dict(jdit=jdit, jvae=jvae, dit_params=dit_params, vae_params=vae_params,
                tdit=tdit, tvae=tvae, tg=tg,
                jtargets=JG.GuidanceTargets(**{k: jnp.asarray(v) for k, v in tg.items()}),
                ttargets=TG.GuidanceTargets(**{
                    k: torch.from_numpy(v).long() if k == "mano_faces" else torch.from_numpy(v)
                    for k, v in tg.items()}))


def _samplers(m, **steps):
    jsampler = JG.GuidedSampler(
        dit=m["jdit"], vae=m["jvae"], camera=JCamera(height=SIZE, width=SIZE, fov_deg=60.0),
        config=JConfig(octree_resolution=RES, **steps), **PHASE_CAPS)
    tsampler = TG.GuidedSampler(
        dit=m["tdit"], vae=m["tvae"], camera=TCamera(height=SIZE, width=SIZE, fov_deg=60.0),
        config=TConfig(octree_resolution=RES, **steps), **PHASE_CAPS)
    return jsampler, tsampler


def _phase_inputs(seed):
    """A latent state and noise prediction whose step_final decodes to a
    surface at the 8^3 grid, and a hand pose a little off the identity."""
    rng = np.random.default_rng(seed)
    return dict(latents=rng.normal(size=(1, 16, 8)).astype(np.float32),
                noise=rng.normal(size=(1, 16, 8)).astype(np.float32),
                hand=(np.float32([1.02]), np.float32([0.01, -0.01, 0.0]),
                      np.float32([0.99, 0.05, -0.03, 0.02])),
                obj=(np.float32([0.97]), np.float32([0.0, 0.01, 0.02]),
                     np.float32([0.98, -0.04, 0.06, 0.01])))


def _jpose(p):
    return JG.PoseParams(*(jnp.asarray(x) for x in p))


def _tpose(p):
    return TG.PoseParams(*(torch.from_numpy(x) for x in p))


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


def test_default_config_runs_every_phase():
    cfg = TConfig()
    assert (cfg.optimization_steps_hand, cfg.optimization_steps_scale,
            cfg.optimization_steps_joint) == (200, 100, 50)
    assert cfg.handopt_start_step == 9 and cfg.num_inference_steps == 20
    defaults = {f.name: f.default for f in dataclasses.fields(TG.GuidedSampler)}
    assert defaults["inloop_coarse_factor"] == 2 and defaults["inloop_cell_cap"] == 10240
    assert defaults["inloop_small_cap"] is None and defaults["vae_remat"] == "none"
