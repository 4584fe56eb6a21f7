"""Batched guidance in the PyTorch port (``GuidedSampler.run_batch``,
``guidance/run.run_batch_images``, ``run(batch_size=...)``) against the JAX
package and against the port's own serial run.

The models are the JAX package's batched-test models (tests/
test_guidance_debug.py's tiny DiT and ShapeVAE, a 64^2 camera, an 8^3 in-loop
grid; their init jitted here) with few optimizer iterations (2 hand, 1
object, 1 joint), the dense in-loop decode and no intersection count (the
two-level decode and the count are held against the reference in
test_torch_phases), on two images whose fields of view differ (40 and 75
degrees, the JAX test's), each image's initial noise drawn from its own JAX
key and injected into the port. Against the JAX ``run_batch`` the schedule
has 2 steps: the hand phase at step 0 and the object phase at step 1 (the
JAX batched joint phase's compile alone takes ~20 s on the CPU); against the
port's serial run of the second image it has 4, with every phase (the joint
one at step 3). The ShapeVAE keeps only the
lowest Fourier frequency of the geo query, so that the random-weight field is
smooth; the object sits at a third of its box scale 2 m away and the tiles
hold 4,096 faces, so that neither rasterizer drops faces (the two packages
would drop other ones).

Tolerances, float32 on both sides:
- against the JAX ``run_batch``: the JAX test's own (its vmapped run against
  its serial runs): latents to 5e-2 relative plus 1e-2, and each image's
  optimized hand translation closer to the JAX image with its own field of
  view than a third of the distance to the other's. The optimizers amplify
  float32 noise (an Adam step is about lr * sign(g)); measured 5.4e-7 on the
  latents, own <= 7.8e-6 against other >= 2.2e-2.
- against the port's serial ``run`` of each image: the DiT at batch 4 and at
  batch 2 sums in another order, which the optimizers amplify: 1e-3 (measured
  7.2e-7 on the latents, 2.4e-8 on the poses, 2.4e-7 relative on the losses).
- threaded exports: bit for bit.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from followmyhold_tpu.configs.guidance import OptimizationConfig as JConfig
from followmyhold_tpu.diffusion import guidance as JG
from followmyhold_tpu.models import hunyuan as JH
from followmyhold_tpu.models.mano import synthetic_mano
from followmyhold_tpu.ops.camera import GuidanceCamera as JCamera
from followmyhold_tpu_torch.configs import profiles as TPROF
from followmyhold_tpu_torch.configs.guidance import OptimizationConfig
from followmyhold_tpu_torch.diffusion import guidance as TG
from followmyhold_tpu_torch.guidance import run as TR
from followmyhold_tpu_torch.models import hunyuan as TH
from followmyhold_tpu_torch.ops.camera import GuidanceCamera
from followmyhold_tpu_torch.tools._scene import write_stage_inputs
from followmyhold_tpu_torch.utils import mesh_io as TIO
from followmyhold_tpu_torch.utils.params import flax_to_torch

FOVS = (40.0, 75.0)
LATENT = (16, 8)
SIZE = 64
STEPS = dict(num_inference_steps=4, optimization_steps_hand=2, optimization_steps_scale=1,
             optimization_steps_joint=1, octree_resolution=8, use_intersection_loss=False)
JAX_STEPS = dict(STEPS, num_inference_steps=2)
CAPS = dict(max_verts=512, max_faces=1024, vae_chunk=128, raster_faces_per_tile=4096,
            inloop_coarse_factor=0)
DIT_KW = dict(in_channels=8, hidden=64, heads=4, depth_double=1, depth_single=1,
              context_dim=32, time_dim=32)
VAE_KW = dict(num_latents=16, embed_dim=8, width=32, heads=4, depth=1, geo_heads=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: its small CPU ops gain little
    from a thread pool, and on a machine whose cores other jobs hold the
    pool's threads spin (a first version of this file ran ~16 min on its
    worker in a six-worker run of the suite on such a machine, ~70 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _smooth_field(vae_params):
    """The geo query's embedding keeps x, sin x and cos x of each axis."""
    params = _np(vae_params)
    kernel = params["params"]["geo"]["query_in"]["kernel"].copy()
    keep = np.zeros(kernel.shape[0], bool)
    keep[[c * 17 + j for c in range(3) for j in (0, 1, 9)]] = True
    kernel[~keep] = 0.0
    params["params"]["geo"]["query_in"]["kernel"] = kernel
    return params


def _numpy_targets():
    """The hand 2 m in front of the camera, the object's box scaled by 0.3
    around it, random normal, disparity and keypoint targets."""
    mano = synthetic_mano()
    rng = np.random.default_rng(0)
    verts = np.asarray(mano.v_template)
    verts = verts - verts.mean(0) + np.array([0, 0, -2.0], np.float32)
    t_h2m = np.eye(4, dtype=np.float32)
    t_h2m[:3, :3] *= 0.3
    t_h2m[2, 3] = -2.0
    hand_mask = np.zeros((SIZE, SIZE), bool)
    hand_mask[20:40, 20:40] = True
    obj_mask = np.zeros((SIZE, SIZE), bool)
    obj_mask[26:46, 26:46] = True
    return dict(mano_verts_moge=verts.astype(np.float32), mano_faces=np.asarray(mano.faces),
                j_regressor=np.asarray(mano.j_regressor),
                hamer_2d_kps=rng.uniform(10, 54, (21, 2)).astype(np.float32),
                moge_normal=rng.uniform(0, 1, (SIZE, SIZE, 3)).astype(np.float32),
                moge_disp=rng.uniform(0, 1, (SIZE, SIZE)).astype(np.float32),
                hand_mask=hand_mask, obj_mask=obj_mask, t_h2m=t_h2m)


def _port_targets(tg, fov):
    return TG.GuidanceTargets(**{
        k: torch.from_numpy(v.astype(np.int64) if k == "mano_faces" else v)
        for k, v in tg.items()}, fov_deg=torch.tensor(fov, dtype=torch.float32))


@pytest.fixture(scope="module")
def models():
    """The JAX models (jitted init), their weights, the port's models with the
    same weights, the two images' targets and initial noise."""
    jdit = JH.HunyuanDiT(JH.DiTConfig(dtype=jnp.float32, **DIT_KW))
    jvae = JH.ShapeVAE(JH.ShapeVAEConfig(dtype=jnp.float32, **VAE_KW))
    key = jax.random.key(0)
    lat = jnp.zeros((1, *LATENT))
    dit_params = _np(jax.jit(jdit.init)(key, lat, jnp.zeros(1), jnp.zeros((1, 4, 32))))
    vae_params = _smooth_field(jax.jit(jvae.init)(key, lat, jnp.zeros((1, 8, 3))))
    tdit = flax_to_torch(dit_params, TH.HunyuanDiT(
        TH.DiTConfig(dtype=torch.float32, **DIT_KW))).eval().requires_grad_(False)
    tvae = flax_to_torch(vae_params, TH.ShapeVAE(
        TH.ShapeVAEConfig(dtype=torch.float32, **VAE_KW))).eval().requires_grad_(False)
    keys = jax.random.split(jax.random.key(7), len(FOVS))
    noise = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (1, *LATENT), jnp.float32))(keys))
    tg = _numpy_targets()
    return dict(jdit=jdit, jvae=jvae, dit_params=dit_params, vae_params=vae_params, tdit=tdit,
                tvae=tvae, keys=keys, noise=torch.from_numpy(noise), tg=tg,
                ttargets=[_port_targets(tg, f) for f in FOVS],
                cond=torch.zeros((len(FOVS), 1, 4, 32)))


def _port_sampler(m, steps):
    return TG.GuidedSampler(dit=m["tdit"], vae=m["tvae"], camera=GuidanceCamera(SIZE, SIZE, 60.0),
                            config=OptimizationConfig(**steps), **CAPS)


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX run_batch and the port's on the 2-step schedule."""
    m = models
    jsampler = JG.GuidedSampler(dit=m["jdit"], vae=m["jvae"], camera=JCamera(SIZE, SIZE, 60.0),
                                config=JConfig(**JAX_STEPS), **CAPS)
    jtargets = JG.GuidanceTargets(**{k: jnp.asarray(v) for k, v in m["tg"].items()})
    per_image = [jtargets._replace(fov_deg=jnp.asarray(f, jnp.float32)) for f in FOVS]
    targets_b = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_image)
    cond_b = jnp.asarray(m["cond"].numpy())
    jres = jsampler.run_batch(m["dit_params"], m["vae_params"], cond_b, cond_b, targets_b,
                              m["keys"], LATENT)
    tres = _port_sampler(m, JAX_STEPS).run_batch(m["cond"], m["cond"], m["ttargets"], LATENT,
                                                 initial_noise=m["noise"], device="cpu")
    return dict(j=_np(jres), t=tres)


# the image whose serial run the batch is held against (the second: its slot
# is not the batch's first)
SERIAL = 1


@pytest.fixture(scope="module")
def runs(models):
    """The port's run_batch on the 4-step schedule, and its serial run of
    image SERIAL."""
    m = models
    tsampler = _port_sampler(m, STEPS)
    tres = tsampler.run_batch(m["cond"], m["cond"], m["ttargets"], LATENT,
                              initial_noise=m["noise"], device="cpu")
    serial = tsampler.run(m["cond"][SERIAL], m["cond"][SERIAL], m["ttargets"][SERIAL], LATENT,
                          initial_noise=m["noise"][SERIAL], device="cpu")
    return dict(t=tres, serial=serial, tsampler=tsampler, ttargets=m["ttargets"],
                cond=m["cond"])


def test_run_batch_matches_reference_with_each_images_fov(jax_runs):
    j, t = jax_runs["j"], jax_runs["t"]
    assert t.latents.shape == j.latents.shape == (2, 1, *LATENT)
    np.testing.assert_allclose(t.latents.numpy(), j.latents, rtol=5e-2, atol=1e-2)
    for b in range(len(FOVS)):
        own = np.linalg.norm(t.hand.trans[b].numpy() - j.hand.trans[b])
        other = np.linalg.norm(t.hand.trans[b].numpy() - j.hand.trans[1 - b])
        assert other > 3.0 * own, (b, own, other)
    # the two fields of view give different poses: neither image took the camera's
    assert not np.allclose(t.hand.trans[0].numpy(), t.hand.trans[1].numpy(), atol=1e-3)


def test_run_batch_reports_per_image_curves_and_stacked_poses(jax_runs, runs):
    j, t = jax_runs["j"], jax_runs["t"]
    assert sorted(t.losses) == sorted(j.losses) == ["hand", "obj"]
    for tag, curve in t.losses.items():
        assert curve.shape == j.losses[tag].shape and curve.shape[0] == 2, tag
    t = runs["t"]
    assert sorted(t.losses) == ["hand", "joint_3", "obj"]
    for tag, curve in t.losses.items():
        want = STEPS["optimization_steps_" + {"hand": "hand", "obj": "scale"}.get(tag, "joint")]
        assert curve.shape == (2, want) and torch.isfinite(curve).all(), tag
    for pose in (t.hand, t.obj):
        assert [tuple(x.shape) for x in pose] == [(2, 1), (2, 3), (2, 4)]
    assert len(t.seconds["dit_steps"]) == 4 and t.seconds["joint"] > 0


def test_run_batch_image_matches_run_of_that_image(runs):
    t, ref, b = runs["t"], runs["serial"], SERIAL
    np.testing.assert_allclose(t.latents[b].numpy(), ref.latents.numpy(), atol=1e-3)
    np.testing.assert_allclose(t.noise_pred[b].numpy(), ref.noise_pred.numpy(), atol=1e-3)
    for name in ("hand", "obj"):
        for x, y in zip(getattr(t, name), getattr(ref, name)):
            np.testing.assert_allclose(x[b].numpy(), y.numpy(), atol=1e-3, err_msg=name)
    for tag, curve in ref.losses.items():
        np.testing.assert_allclose(t.losses[tag][b].numpy(), curve.numpy(), rtol=1e-3,
                                   err_msg=tag)
    # the other image took another field of view: its losses differ
    assert not np.allclose(t.losses["hand"][1 - b].numpy(), ref.losses["hand"].numpy())


def test_threaded_export_matches_serial(runs):
    """Two exports at once, as run_batch_images runs them, on the device's
    dense path and on the host's two-level path: the same bits as one at a
    time."""
    sampler, t = runs["tsampler"], runs["t"]

    def export(b, res_limit):
        res = TG.GuidanceResult(latents=t.latents[b], noise_pred=t.noise_pred[b],
                                hand=TG.PoseParams(*(x[b] for x in t.hand)),
                                obj=TG.PoseParams(*(x[b] for x in t.obj)))
        mesh, hand = sampler.export_meshes(res, runs["ttargets"][b], octree_resolution=16,
                                           device_res_limit=res_limit, device="cpu")
        return [x.numpy() for x in (*mesh, hand)]

    for res_limit in (256, 8):
        serial = [export(b, res_limit) for b in range(2)]
        with ThreadPoolExecutor(max_workers=2) as pool:
            threaded = [f.result() for f in [pool.submit(export, b, res_limit)
                                             for b in range(2)]]
        for s, th in zip(serial, threaded):
            assert s[1].shape[0] > 0
            for a, c in zip(s, th):
                np.testing.assert_array_equal(a, c)


def test_capacity_warnings_say_batched(runs, capsys):
    sampler = dataclasses.replace(runs["tsampler"], raster_faces_per_tile=256,
                                  config=OptimizationConfig(**dict(
                                      STEPS, optimization_steps_hand=1,
                                      optimization_steps_scale=1, optimization_steps_joint=1)))
    noise = torch.zeros((2, 1, *LATENT))
    sampler.run_batch(runs["cond"], runs["cond"], runs["ttargets"], LATENT, initial_noise=noise,
                      device="cpu")
    assert "faces in the densest tile" in capsys.readouterr().out.split("(batched)")[1]


# ---- the stage: run(batch_size=2) ------------------------------------------ #

def _dirs_args(d):
    return (d["cropped_obj_img_dir"], d["mask_dir"], d["moge_out_dir"],
            d["hunyuan_hoi_mesh_dir"], d["hamer_out_dir"], d["h2m_rt_dir"],
            d["aligned_mano_dir"], d["guidance_out_dir"])


def _stage_inputs(root):
    """Five images: 000001 and 000002 to run (50 and 70 degrees), 000003 done,
    000004 with an empty hand mask, 000005 without its T_h2m."""
    d = write_stage_inputs(str(root), image_id="000001", size=SIZE, moge_grid=(24, 32),
                           fov_deg=50.0)
    for image_id, fov in (("000002", 70.0), ("000003", 60.0), ("000004", 60.0),
                          ("000005", 60.0)):
        write_stage_inputs(str(root), image_id=image_id, size=SIZE, moge_grid=(24, 32),
                           fov_deg=fov, seed=int(image_id))
    for name in ("000003_obj.ply", "000003_hand.ply"):
        (root / "guidance_out_dir" / name).write_bytes(b"")
    Image.fromarray(np.zeros((SIZE, SIZE), np.uint8)).save(
        os.path.join(d["mask_dir"], "000004_cropped_hand_mask.png"))
    os.remove(os.path.join(d["h2m_rt_dir"], "000005_hoi_mesh.npy"))
    return d


def test_run_batch_size_2_writes_both_plys_and_skips(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    monkeypatch.setenv("FOHO_DEBUG_DIR", str(tmp_path / "debug"))
    # the tiny profile without the intersection count (seconds of winding
    # numbers on the CPU; the count is held against the reference elsewhere)
    monkeypatch.setattr(TR, "optimization_config", lambda: dataclasses.replace(
        TPROF.optimization_config(), use_intersection_loss=False))
    d = _stage_inputs(tmp_path)
    batches = []
    batch_images = TR.run_batch_images

    def recorded(jobs, *args, **kwargs):
        batches.append([(job["image_id"], job["fovx"]) for job in jobs])
        return batch_images(jobs, *args, **kwargs)

    monkeypatch.setattr(TR, "run_batch_images", recorded)
    TR.run(str(tmp_path), *_dirs_args(d), batch_size=2, device="cpu")
    printed = capsys.readouterr().out
    assert batches == [[("000001", 50.0), ("000002", 70.0)]]
    assert "000003 already exists, skipping" in printed
    assert "Skipping 000004 due to empty mask" in printed
    assert "Skipping 000005: missing artifacts" in printed
    assert "Finished processing all images" in printed
    for image_id in ("000001", "000002"):
        obj = TIO.load_mesh(os.path.join(d["guidance_out_dir"], f"{image_id}_obj.ply"))
        hand = TIO.load_mesh(os.path.join(d["guidance_out_dir"], f"{image_id}_hand.ply"))
        assert obj.num_faces > 0 and np.isfinite(obj.vertices).all()
        assert hand.num_vertices == 778
        lines = (tmp_path / "debug" / f"exp_obj{image_id}_inpainted" / "losses.txt").read_text()
        assert "hand final" in lines and "joint_5 final" in lines


def test_a_failing_batch_is_reported_with_its_traceback(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    d = _stage_inputs(tmp_path)
    for name in ("000003_obj.ply", "000003_hand.ply"):
        os.remove(os.path.join(d["guidance_out_dir"], name))
    seen = []

    def failing(jobs, *args, **kwargs):
        seen.append([job["image_id"] for job in jobs])
        if len(seen) == 1:
            raise ValueError("batch broke")

    monkeypatch.setattr(TR, "run_batch_images", failing)
    TR.run(str(tmp_path), *_dirs_args(d), batch_size=2, device="cpu")
    captured = capsys.readouterr()
    printed = captured.out + captured.err
    assert seen == [["000001", "000002"], ["000003"]]      # the next batch ran
    assert "Error in batch ['000001', '000002']: batch broke" in printed
    assert printed.count("Traceback (most recent call last)") == 1
    assert 'raise ValueError("batch broke")' in printed


def test_batched_entry_points_need_an_existing_device(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runs["tsampler"].run_batch(runs["cond"], runs["cond"], runs["ttargets"], LATENT,
                                   initial_noise=torch.zeros((2, 1, *LATENT)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.run_batch_images([], OptimizationConfig(), None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.run(str(tmp_path), *(str(tmp_path),) * 8, batch_size=2)
