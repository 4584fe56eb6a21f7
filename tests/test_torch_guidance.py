"""The ported slice as a whole against the JAX package: same weights (through
the bridge), same initial noise, same targets. 6 CFG steps of the DiT, a hand
phase of a few Adam steps through render and losses, the scheduler advance,
then ``export_meshes``.

The JAX side is assembled from the package's own jitted phases (``dit_step``,
``hand_phase``, ``advance``) and ``export_meshes``: its ``run`` cannot be called
with zero object and joint steps. Its rasterizer runs the Pallas kernels in
interpret mode, whose semantics the port's plain version has.

Tolerances: float32 on both sides. The latents pass through 6 DiT evaluations
(1e-4; measured 2e-6). An Adam step is lr * m/(sqrt(v) + eps), so a relative
error in a gradient component becomes the same relative error of a step of size
lr; the gradients are dense pixel sums in which a few pixels are ill-conditioned
in float32 (see test_torch_rasterizer: 2e-2 of the largest gradient at worst).
After 3 steps that bounds the raw quaternion (lr 0.5) by 0.5 * 2e-2 = 1e-2
(measured 2.4e-3) and scale and translation (lr 1e-2) by 5e-4 (measured 3e-5);
the loss curve agrees to 1e-3 relative (measured 5e-5) and the posed hand
vertices to 3e-3 (measured 4e-4, on a hand 0.3 across).
"""

import functools
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from followmyhold_tpu.configs.guidance import OptimizationConfig as JConfig
from followmyhold_tpu.diffusion import guidance as JG
from followmyhold_tpu.models import hunyuan as JH
from followmyhold_tpu.models.mano import synthetic_mano as j_synthetic_mano
from followmyhold_tpu.ops import rasterizer as JR
from followmyhold_tpu.ops.camera import GuidanceCamera as JCamera
from followmyhold_tpu_torch.configs.guidance import OptimizationConfig as TConfig
from followmyhold_tpu_torch.diffusion import guidance as TG
from followmyhold_tpu_torch.diffusion.pipeline import denoise_latents, latents_to_mesh
from followmyhold_tpu_torch.models import hunyuan as TH
from followmyhold_tpu_torch.ops.camera import GuidanceCamera as TCamera
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


SIZE = 128   # a multiple of the reference's 128x128 kernel tile, or it renders through XLA
N_STEPS = 6
N_HAND = 3
RES = 8
CAPS = dict(max_verts=2048, max_faces=4096, vae_chunk=128, raster_faces_per_tile=2048)


@contextmanager
def _pallas_interpret_on_cpu():
    orig_call, orig_on_tpu = pl.pallas_call, JR._on_tpu
    pl.pallas_call = functools.partial(orig_call, interpret=True)
    JR._on_tpu = lambda: True
    JR._raster_tiles_pallas.cache_clear()
    try:
        yield
    finally:
        pl.pallas_call, JR._on_tpu = orig_call, orig_on_tpu
        JR._raster_tiles_pallas.cache_clear()


def _numpy_targets():
    mano = j_synthetic_mano()
    rng = np.random.default_rng(0)
    mverts = np.asarray(mano.v_template)
    mverts = (mverts - mverts.mean(0) + np.array([0, 0, -0.8], np.float32)).astype(np.float32)
    hand_mask = np.zeros((SIZE, SIZE), bool)
    hand_mask[40:80, 40:80] = True
    obj_mask = np.zeros((SIZE, SIZE), bool)
    obj_mask[60:100, 60:100] = True
    t_h2m = np.eye(4, dtype=np.float32)
    t_h2m[:3, :3] *= 0.25
    t_h2m[2, 3] = -0.8
    return dict(
        mano_verts_moge=mverts,
        mano_faces=np.asarray(mano.faces),
        j_regressor=np.asarray(mano.j_regressor),
        hamer_2d_kps=rng.uniform(20, 108, (21, 2)).astype(np.float32),
        moge_normal=rng.uniform(0, 1, (SIZE, SIZE, 3)).astype(np.float32),
        moge_disp=rng.uniform(0, 1, (SIZE, SIZE)).astype(np.float32),
        hand_mask=hand_mask, obj_mask=obj_mask, t_h2m=t_h2m)


@pytest.fixture(scope="module")
def both_runs():
    """Run the slice once on each side; the tests below compare the pieces."""
    dit_kw = dict(in_channels=8, hidden=64, heads=4, depth_double=1, depth_single=1,
                  context_dim=32, time_dim=32)
    vae_kw = dict(num_latents=16, embed_dim=8, width=32, heads=4, depth=1, geo_heads=4)
    jdit = JH.HunyuanDiT(JH.DiTConfig(dtype=jnp.float32, **dit_kw))
    jvae = JH.ShapeVAE(JH.ShapeVAEConfig(dtype=jnp.float32, **vae_kw))
    key = jax.random.key(0)
    dit_params = jdit.init(key, jnp.zeros((1, 16, 8)), jnp.zeros(1), jnp.zeros((1, 4, 32)))
    vae_params = jvae.init(key, jnp.zeros((1, 16, 8)), jnp.zeros((1, 8, 3)))
    # a logit bias near the field's level, so the random-weight SDF has a surface
    rng = np.random.default_rng(1)
    cond = rng.normal(size=(1, 4, 32)).astype(np.float32)
    uncond = np.zeros_like(cond)
    noise = np.asarray(jax.random.normal(jax.random.key(1), (1, 16, 8), jnp.float32))
    tg = _numpy_targets()
    steps = dict(num_inference_steps=N_STEPS, optimization_steps_hand=N_HAND,
                 octree_resolution=RES)

    # ---- JAX reference: the package's own phases, zero object/joint steps ---- #
    jsampler = JG.GuidedSampler(
        dit=jdit, vae=jvae, camera=JCamera(height=SIZE, width=SIZE, fov_deg=60.0),
        config=JConfig(optimization_steps_scale=0, optimization_steps_joint=0, **steps),
        inloop_coarse_factor=0, **CAPS)
    jtargets = JG.GuidanceTargets(**{k: jnp.asarray(v) for k, v in tg.items()})
    hand_phase, _, _, advance, dit_step = JG._jitted_phases(jsampler)
    cfg = jsampler.config
    sched = jsampler._schedule(N_STEPS)
    with _pallas_interpret_on_cpu(), jax.default_matmul_precision("highest"):
        latents = jnp.asarray(noise)
        hand = JG.init_pose()
        cond_cat = jnp.concatenate([jnp.asarray(cond), jnp.asarray(uncond)], axis=0)
        for i in range(N_STEPS):
            g = (cfg.obj_guidance_scale * (1 - i / N_STEPS)
                 if i >= cfg.guidance_start_step + 1 else cfg.obj_guidance_scale)
            noise_pred = dit_step(dit_params, cond_cat, latents,
                                  sched.timesteps[i] / sched.num_train_timesteps, g)
            if i == cfg.handopt_start_step:
                hand, hand_losses, _ = hand_phase(hand, jtargets)
            latents = advance(sched, i, noise_pred, latents)
        jresult = JG.GuidanceResult(latents=latents, noise_pred=noise_pred, hand=hand,
                                    obj=JG.init_pose(), losses={"hand": hand_losses})
        jmesh, jhand_verts = jsampler.export_meshes(vae_params, jresult, jtargets)
        jmesh = jax.tree_util.tree_map(np.asarray, jmesh)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)

    # ---- the port ------------------------------------------------------------ #
    tdit = flax_to_torch(to_np(dit_params), TH.HunyuanDiT(
        TH.DiTConfig(dtype=torch.float32, **dit_kw))).eval().requires_grad_(False)
    tvae = flax_to_torch(to_np(vae_params), TH.ShapeVAE(
        TH.ShapeVAEConfig(dtype=torch.float32, **vae_kw))).eval().requires_grad_(False)
    tsampler = TG.GuidedSampler(
        dit=tdit, vae=tvae, camera=TCamera(height=SIZE, width=SIZE, fov_deg=60.0),
        config=TConfig(optimization_steps_scale=0, optimization_steps_joint=0, **steps),
        **CAPS)
    ttargets = TG.GuidanceTargets(**{
        k: torch.from_numpy(v).long() if k == "mano_faces" else torch.from_numpy(v)
        for k, v in tg.items()})
    tresult = tsampler.run(torch.from_numpy(cond), torch.from_numpy(uncond), ttargets,
                           (16, 8), initial_noise=torch.from_numpy(noise), device="cpu")
    tmesh, thand_verts = tsampler.export_meshes(tresult, ttargets, device="cpu")
    return dict(j=to_np(jresult), jmesh=jmesh, jhand_verts=np.asarray(jhand_verts),
                t=tresult, tmesh=tmesh, thand_verts=thand_verts, tsampler=tsampler,
                ttargets=ttargets, cond=cond, noise=noise, tdit=tdit, tvae=tvae)


def test_final_latents_and_noise_prediction_match(both_runs):
    j, t = both_runs["j"], both_runs["t"]
    assert t.latents.shape == (1, 16, 8)
    np.testing.assert_allclose(t.latents.numpy(), j.latents, atol=1e-4)
    np.testing.assert_allclose(t.noise_pred.numpy(), j.noise_pred, atol=1e-4)


def test_hand_loss_curve_matches(both_runs):
    j, t = both_runs["j"], both_runs["t"]
    curve = t.losses["hand"].numpy()
    assert curve.shape == (N_HAND,) and np.isfinite(curve).all()
    np.testing.assert_allclose(curve, j.losses["hand"], rtol=1e-3)


def test_final_hand_pose_matches(both_runs):
    j, t = both_runs["j"], both_runs["t"]
    for name, atol in (("scale", 5e-4), ("trans", 5e-4), ("quat", 1e-2)):
        got, want = getattr(t.hand, name).numpy(), getattr(j.hand, name)
        np.testing.assert_allclose(got, want, atol=atol, err_msg=name)
    assert not np.allclose(t.hand.quat.numpy(), [1, 0, 0, 0])   # the pose did move
    # with no object or joint steps the object pose is not optimized
    np.testing.assert_array_equal(t.obj.quat.numpy(), np.float32([1, 0, 0, 0]))


def test_exported_meshes_match(both_runs):
    jmesh, tmesh = both_runs["jmesh"], both_runs["tmesh"]
    nv, nf = int(jmesh.vert_mask.sum()), int(jmesh.face_mask.sum())
    assert 0 < nv < CAPS["max_verts"] and 0 < nf < CAPS["max_faces"]   # below the caps
    assert (tmesh.num_verts, tmesh.num_faces) == (nv, nf)
    np.testing.assert_array_equal(tmesh.faces.numpy(), jmesh.faces)
    np.testing.assert_allclose(tmesh.verts.numpy(), jmesh.verts, atol=2e-4)
    np.testing.assert_allclose(both_runs["thand_verts"].numpy(), both_runs["jhand_verts"],
                               atol=3e-3)


def test_run_reports_phase_seconds(both_runs):
    seconds = both_runs["t"].seconds
    assert len(seconds["dit_steps"]) == N_STEPS and seconds["hand"] > 0


def test_entry_points_need_an_existing_device(both_runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cond = torch.from_numpy(both_runs["cond"])
    sampler, targets = both_runs["tsampler"], both_runs["ttargets"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampler.run(cond, cond, targets, (16, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampler.export_meshes(both_runs["t"], targets)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        denoise_latents(both_runs["tdit"], cond, cond, (16, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.init_pose()


def test_export_above_the_device_limit_is_refused(both_runs):
    """Above ``device_res_limit`` the export is no longer refused: it takes the
    two-level decode and the host's exact-shape marching tets, whose surface
    is the dense decode's wherever the selected cells fit their cap."""
    from followmyhold_tpu_torch.models.hunyuan import vae_query_logits
    from followmyhold_tpu_torch.ops.grid import generate_dense_grid_points
    from followmyhold_tpu_torch.ops.surface import marching_tets_host

    sampler, t = both_runs["tsampler"], both_runs["t"]
    mesh, _ = sampler.export_meshes(t, both_runs["ttargets"], octree_resolution=RES,
                                    device_res_limit=RES // 2, device="cpu")
    xyz, _, _ = generate_dense_grid_points([-sampler.box_v] * 3, [sampler.box_v] * 3, RES,
                                           device="cpu")
    with torch.no_grad():
        dense = -vae_query_logits(sampler.vae, t.latents, xyz[None])[0]
    want_v, want_f = marching_tets_host(dense.numpy(), [-sampler.box_v] * 3,
                                        [sampler.box_v] * 3, RES)
    assert len(want_f) > 0
    assert mesh.faces.shape[0] == len(want_f) and mesh.num_faces == len(want_f)
    np.testing.assert_array_equal(mesh.faces.numpy(), want_f)
    posed = both_runs["tmesh"]   # the dense device export, posed: the same surface
    assert posed.num_faces == len(want_f)


def test_plain_sampling_pipeline_matches(both_runs):
    """denoise_latents + latents_to_mesh against the JAX pipeline."""
    from followmyhold_tpu.diffusion import pipeline as JP

    # reuse the bridged weights: rebuild the Flax side from the same init
    dit_kw = dict(in_channels=8, hidden=64, heads=4, depth_double=1, depth_single=1,
                  context_dim=32, time_dim=32)
    vae_kw = dict(num_latents=16, embed_dim=8, width=32, heads=4, depth=1, geo_heads=4)
    jdit = JH.HunyuanDiT(JH.DiTConfig(dtype=jnp.float32, **dit_kw))
    jvae = JH.ShapeVAE(JH.ShapeVAEConfig(dtype=jnp.float32, **vae_kw))
    key = jax.random.key(0)
    dit_params = jdit.init(key, jnp.zeros((1, 16, 8)), jnp.zeros(1), jnp.zeros((1, 4, 32)))
    vae_params = jvae.init(key, jnp.zeros((1, 16, 8)), jnp.zeros((1, 8, 3)))
    cond, noise = both_runs["cond"], both_runs["noise"]
    with jax.default_matmul_precision("highest"):
        jlat = JP.denoise_latents(jdit, dit_params, jnp.asarray(cond),
                                  jnp.zeros_like(jnp.asarray(cond)), key, (16, 8),
                                  num_inference_steps=5, guidance_scale=3.0,
                                  initial_noise=jnp.asarray(noise))
        jmesh = JP.latents_to_mesh(jvae, vae_params, jlat, octree_resolution=RES,
                                   max_verts=2048, max_faces=4096, chunk=128)
    tlat = denoise_latents(both_runs["tdit"], torch.from_numpy(cond),
                           torch.zeros(cond.shape), (16, 8), num_inference_steps=5,
                           guidance_scale=3.0, initial_noise=torch.from_numpy(noise),
                           device="cpu")
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=1e-4)
    tmesh = latents_to_mesh(both_runs["tvae"], tlat, octree_resolution=RES, max_verts=2048,
                            max_faces=4096, chunk=128, device="cpu")
    assert tmesh.num_faces == int(jmesh.num_faces)
    np.testing.assert_array_equal(tmesh.faces.numpy(), np.asarray(jmesh.faces))
    np.testing.assert_allclose(tmesh.verts.numpy(), np.asarray(jmesh.verts), atol=2e-4)


def test_decode_object_matches(both_runs):
    """step_final -> dense decode -> marching tets, against the JAX helper."""
    from followmyhold_tpu.diffusion.scheduler import make_schedule as j_make_schedule
    from followmyhold_tpu.ops.grid import generate_dense_grid_points as j_grid

    dit_kw = dict(num_latents=16, embed_dim=8, width=32, heads=4, depth=1, geo_heads=4)
    jvae = JH.ShapeVAE(JH.ShapeVAEConfig(dtype=jnp.float32, **dit_kw))
    vae_params = jvae.init(jax.random.key(0), jnp.zeros((1, 16, 8)), jnp.zeros((1, 8, 3)))
    rng = np.random.default_rng(3)
    lat = rng.normal(size=(1, 16, 8)).astype(np.float32)
    eps = rng.normal(size=(1, 16, 8)).astype(np.float32)
    sigmas = np.linspace(0, 1, N_STEPS)
    xyz, _, _ = j_grid([-1.1] * 3, [1.1] * 3, RES)
    bbox = (jnp.asarray([-1.1] * 3), jnp.asarray([1.1] * 3))
    with jax.default_matmul_precision("highest"):
        jmesh, jsdf, _ = JG._decode_object(
            jvae, vae_params, j_make_schedule(sigmas=sigmas), 3, jnp.asarray(eps),
            jnp.asarray(lat), xyz, bbox, RES, 2048, 4096, 128, hier_cf=0)
    sampler = both_runs["tsampler"]
    txyz, tbbox = sampler._grid(RES, torch.device("cpu"))
    tmesh, tsdf, _ = TG._decode_object(
        both_runs["tvae"], sampler._schedule(N_STEPS), 3, torch.from_numpy(eps),
        torch.from_numpy(lat), txyz, tbbox, RES, 2048, 4096, 128)
    np.testing.assert_allclose(tsdf.numpy(), np.asarray(jsdf), atol=1e-4)
    assert tmesh.num_faces == int(jmesh.num_faces) > 0
    np.testing.assert_array_equal(tmesh.faces.numpy(), np.asarray(jmesh.faces))
    np.testing.assert_allclose(tmesh.verts.numpy(), np.asarray(jmesh.verts), atol=2e-4)
