"""Entries into the port for a harness: one CFG denoise step of the flagship
DiT, and the guidance train step over a dp x tp mesh of ranks.

Counterparts of ``__graft_entry__.entry()`` and ``dryrun_multichip()`` at the
repository's root:

- ``entry()`` returns ``(fn, args)``, and ``fn(*args)`` runs the Hunyuan3D-2
  DiT (seeded random weights, ``DIT_FULL`` by default) at batch 2 on [1, 3072,
  64] latents and 1,370 condition tokens (the DINOv2-G grid and its cls
  token), takes the classifier-free guidance at scale 5.0 and advances the
  latents by one step of the 20-step flow-matching schedule. At full width
  that step runs the flash-attention forward at [2, 16, 4442, 128], once in
  each of the 24 blocks.
- ``dryrun_multichip(n)`` spawns n ranks (one process each, a
  ``torch.distributed`` group met through a file in a temporary directory)
  and forms a dp x tp mesh (tp = 2 where n is even): the tiny-but-complete
  DiT and ShapeVAE sharded over tp, the images over dp. Each rank runs ONE
  guidance train step per image of its dp index (a CFG DiT forward, then the
  joint phase near the end of a 6-step schedule, two AdamW steps that
  differentiate through the ShapeVAE's two-level grid decode, marching tets
  and the rasterizer, then a loss proxy), and the per-image losses are
  gathered over dp, returned and printed. ``dryrun_losses`` runs the same
  step in one process, with or without a mesh.

    python -c "from followmyhold_tpu_torch.entry import entry; fn, a = entry(); fn(*a)"
    python -c "from followmyhold_tpu_torch.entry import dryrun_multichip as d; d(4)"
    python -c "from followmyhold_tpu_torch.entry import dryrun_multichip as d; \\
        d(4, device_type='cpu', backend='gloo')"
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from followmyhold_tpu_torch.diffusion.scheduler import make_schedule, step
from followmyhold_tpu_torch.models.hunyuan import DIT_FULL, DiTConfig, HunyuanDiT
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device
from followmyhold_tpu_torch.utils.params import init_random_

NUM_LATENTS = 3072
COND_TOKENS = 1370       # DINOv2-G's 37x37 grid and its cls token
GUIDANCE_SCALE = 5.0


def entry(cfg: DiTConfig = DIT_FULL, device: DeviceLike = "cuda"):
    """(fn, (dit, latents, cond, step_index)): one CFG denoise step."""
    dev = resolve_device(device)
    dit = init_random_(HunyuanDiT(cfg, device=dev), seed=2).eval().requires_grad_(False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    latents = torch.randn((1, NUM_LATENTS, cfg.in_channels), generator=gen, device=dev)
    cond = torch.randn((2, COND_TOKENS, cfg.context_dim), generator=gen,
                       device=dev).to(torch.bfloat16)
    sched = make_schedule(sigmas=np.linspace(0, 1, 20))

    @torch.no_grad()
    def denoise_step(dit: HunyuanDiT, latents: torch.Tensor, cond: torch.Tensor,
                     i: int) -> torch.Tensor:
        t = np.float32(sched.timesteps[i]) / np.float32(sched.num_train_timesteps)
        lat_in = torch.cat([latents, latents], dim=0)
        tt = torch.full((2,), float(t), dtype=latents.dtype, device=latents.device)
        eps = dit(lat_in, tt, cond)
        eps_c, eps_u = eps.chunk(2, dim=0)
        eps_cfg = eps_u + GUIDANCE_SCALE * (eps_c - eps_u)
        new_latents, _ = step(sched, i, eps_cfg, latents)
        return new_latents

    return denoise_step, (dit, latents, cond, 0)


# --------------------------------------------------------------------------- #
# the multi-rank dry run
# --------------------------------------------------------------------------- #

DRYRUN_SIZE = 64          # the camera's height and width
DRYRUN_STEP = 4           # the schedule step the train step runs (of 6)
DRYRUN_HEADS = 4


def dryrun_configs():
    """(DiTConfig, ShapeVAEConfig, OptimizationConfig, sampler keywords) of
    the dry run: the reference's tiny-but-complete models and settings."""
    from followmyhold_tpu_torch.configs.guidance import OptimizationConfig
    from followmyhold_tpu_torch.models.hunyuan import ShapeVAEConfig

    dit_cfg = DiTConfig(in_channels=8, hidden=64, heads=DRYRUN_HEADS, depth_double=1,
                        depth_single=2, context_dim=32, time_dim=32, dtype=torch.float32)
    vae_cfg = ShapeVAEConfig(num_latents=16, embed_dim=8, width=32, heads=DRYRUN_HEADS,
                             depth=1, geo_heads=DRYRUN_HEADS, dtype=torch.float32)
    cfg = OptimizationConfig(num_inference_steps=6, optimization_steps_hand=2,
                             optimization_steps_scale=2, optimization_steps_joint=2,
                             octree_resolution=8)
    # inloop_coarse_factor=2 takes the two-level grid decode
    sampler_kw = dict(max_verts=512, max_faces=1024, vae_chunk=128, raster_faces_per_tile=256,
                      inloop_coarse_factor=2, inloop_cell_cap=64)
    return dit_cfg, vae_cfg, cfg, sampler_kw


def dryrun_inputs(n_images: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Numpy inputs of n images, each leading with the image: the targets'
    fields (the synthetic MANO hand 2 units in front of the camera, random
    keypoints, normal and disparity maps, square hand and object masks),
    ``noise`` and ``latents`` [n,1,16,8], ``cond_cat`` [n,2,4,32] (condition
    and unconditional tokens). Seeded with numpy, so that another package can
    take the same arrays."""
    from followmyhold_tpu_torch.models.mano import synthetic_mano

    H = W = DRYRUN_SIZE
    mano = synthetic_mano(device="cpu")
    mverts = mano.v_template.numpy()
    mverts = (mverts - mverts.mean(0) + np.float32([0, 0, -2.0])).astype(np.float32)
    hand_mask = np.zeros((H, W), bool)
    hand_mask[20:40, 20:40] = True
    obj_mask = np.zeros((H, W), bool)
    obj_mask[30:50, 30:50] = True
    t_h2m = np.eye(4, dtype=np.float32)
    t_h2m[2, 3] = -2.0
    per: Dict[str, List[np.ndarray]] = {}
    for b in range(n_images):
        r = np.random.default_rng(seed * 1000 + b)
        image = dict(
            mano_verts_moge=mverts, mano_faces=mano.faces.numpy(),
            j_regressor=mano.j_regressor.numpy(),
            hamer_2d_kps=r.uniform(10, 54, (21, 2)).astype(np.float32),
            moge_normal=r.uniform(0, 1, (H, W, 3)).astype(np.float32),
            moge_disp=r.uniform(0, 1, (H, W)).astype(np.float32),
            hand_mask=hand_mask, obj_mask=obj_mask, t_h2m=t_h2m,
            noise=r.standard_normal((1, 16, 8)).astype(np.float32),
            latents=r.standard_normal((1, 16, 8)).astype(np.float32),
            cond_cat=r.standard_normal((2, 4, 32)).astype(np.float32))
        for k, v in image.items():
            per.setdefault(k, []).append(v)
    return {k: np.stack(v) for k, v in per.items()}


def dryrun_targets(x: Dict[str, np.ndarray], b: int, device: DeviceLike = "cuda"):
    """Image b's GuidanceTargets of ``dryrun_inputs``' arrays (the field of
    view is the camera's)."""
    from followmyhold_tpu_torch.diffusion.guidance import GuidanceTargets

    dev = resolve_device(device)

    def leaf(k):
        v = torch.from_numpy(x[k][b])
        return (v.long() if k == "mano_faces" else v).to(dev)

    return GuidanceTargets(**{k: leaf(k) for k in GuidanceTargets._fields[:-1]})


def dryrun_models(device: DeviceLike = "cuda", weights: Optional[Tuple[dict, dict]] = None):
    """(dit, vae) of the dry run on ``device``: seeded random weights, or the
    given (DiT, ShapeVAE) state dicts."""
    from followmyhold_tpu_torch.models.hunyuan import ShapeVAE

    dev = resolve_device(device)
    dit_cfg, vae_cfg, _, _ = dryrun_configs()
    dit, vae = HunyuanDiT(dit_cfg, device=dev), ShapeVAE(vae_cfg, device=dev)
    if weights is None:
        init_random_(dit, seed=2)
        init_random_(vae, seed=3)
    else:
        dit.load_state_dict(weights[0])
        vae.load_state_dict(weights[1])
    return dit.eval().requires_grad_(False), vae.eval().requires_grad_(False)


def dryrun_losses(n_images: int, device: DeviceLike = "cuda", mesh=None,
                  weights: Optional[Tuple[dict, dict]] = None, seed: int = 0,
                  sampler_kw: Optional[dict] = None) -> torch.Tensor:
    """The per-image losses [n_images] of the dry run's train step. With a
    mesh (``parallel.make_mesh``, every rank calling), the models are sharded
    over its tp axis and each rank runs the images of its dp index; the
    losses are gathered over dp, so every rank returns all of them.
    ``sampler_kw`` overrides the sampler's settings (a test raises the
    raster capacity above the hand's faces, where another package's
    rasterizer drops other faces)."""
    from followmyhold_tpu_torch.diffusion.guidance import GuidedSampler
    from followmyhold_tpu_torch.ops.camera import GuidanceCamera
    from followmyhold_tpu_torch.parallel.mesh import (
        batch_sharding,
        rank_device,
        replicate,
        shard_model_params,
    )

    dev = rank_device(mesh) if mesh is not None else resolve_device(device)
    dit, vae = dryrun_models(dev, weights)
    shard = replicate(mesh)
    if mesh is not None:
        shard_model_params(dit, mesh)
        shard_model_params(vae, mesh)
        if "dp" in (mesh.mesh_dim_names or ()):
            shard = batch_sharding(mesh, "dp")
    _, _, cfg, kw = dryrun_configs()
    sampler = GuidedSampler(dit=dit, vae=vae, camera=GuidanceCamera(
        height=DRYRUN_SIZE, width=DRYRUN_SIZE, fov_deg=60.0), config=cfg,
        **dict(kw, **(sampler_kw or {})))
    sched = sampler._schedule(cfg.num_inference_steps)
    x = dryrun_inputs(n_images, seed)
    losses = []
    for b in range(*shard.bounds(n_images)):
        losses.append(_dryrun_train_step(
            sampler, torch.from_numpy(x["noise"][b]).to(dev),
            torch.from_numpy(x["latents"][b]).to(dev),
            torch.from_numpy(x["cond_cat"][b]).to(dev), dryrun_targets(x, b, dev), sched))
    return shard.gather(torch.stack(losses))


def _dryrun_train_step(sampler, noise, lat, cond_cat, targets, sched) -> torch.Tensor:
    """One image's guidance train step: a CFG DiT forward, one joint phase
    (its optimizer steps differentiate through the decode, marching tets and
    the renders), then the loss proxy of the reference's step."""
    from followmyhold_tpu_torch.diffusion.guidance import init_pose

    dev = lat.device
    t = np.float32(sched.timesteps[DRYRUN_STEP]) / np.float32(sched.num_train_timesteps)
    with torch.no_grad():
        eps = sampler.dit(torch.cat([lat, lat]), torch.full((2,), float(t), device=dev),
                          cond_cat)
    eps_c, eps_u = eps.chunk(2, dim=0)
    noise = eps_u + GUIDANCE_SCALE * (eps_c - eps_u) + 0.0 * noise
    hand, obj, noise, _, _ = sampler._joint_phase(
        init_pose(dev), init_pose(dev), noise, lat, targets, sched, DRYRUN_STEP, near_end=True)
    return (noise.square().sum() + hand.trans.square().sum() + obj.trans.square().sum()).detach()


def _dryrun_rank(rank: int, n_devices: int, init_file: str, device_type: str, backend: str,
                 weights, sampler_kw, out_dir: str) -> None:
    """One rank of ``dryrun_multichip`` (a function of the package, so that a
    spawned interpreter imports it): joins the group, makes the mesh, runs
    its images and writes its report (the losses on rank 0; each rank's
    kernel launches, seconds and peak card memory)."""
    import torch.distributed as dist

    from followmyhold_tpu_torch.ops import _kernels
    from followmyhold_tpu_torch.parallel.mesh import make_mesh

    if device_type == "cpu":
        torch.set_num_threads(1)      # the ranks share the host's cores
    t0 = time.perf_counter()
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=n_devices)
    try:
        tp = 2 if n_devices % 2 == 0 else 1
        mesh = make_mesh(f"dp={n_devices // tp},tp={tp}", device_type=device_type,
                         backend=backend)
        t_mesh = time.perf_counter()
        if device_type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        losses = dryrun_losses(n_devices // tp, mesh=mesh, weights=weights,
                               sampler_kw=sampler_kw)
        if device_type == "cuda":
            torch.cuda.synchronize()
        report = dict(rank=rank, losses=losses.cpu(), launches=_kernels.launch_counts(),
                      rendezvous_s=t_mesh - t0, step_s=time.perf_counter() - t_mesh,
                      peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                                if device_type == "cuda" else None))
        torch.save(report, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device_type: str = "cuda", backend: str = "nccl",
                     weights: Optional[Tuple[dict, dict]] = None,
                     sampler_kw: Optional[dict] = None,
                     reports: Optional[list] = None) -> np.ndarray:
    """The guidance train step over an n-rank dp x tp mesh (tp = 2 where n is
    even, dp = n / tp), one spawned process a rank. ``device_type`` and
    ``backend`` are the mesh's (NCCL takes one card a rank; several ranks on
    one card take gloo). ``weights``: (DiT, ShapeVAE) state dicts, else the
    seeded ones; ``sampler_kw``: as ``dryrun_losses``'. An exception on any
    rank raises here. -> the per-image
    losses [dp]; ``reports`` (a list) receives each rank's report."""
    import torch.multiprocessing as mp

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip(device_type='cuda'): no CUDA device is present; "
                           "pass device_type='cpu' and backend='gloo' to run on the CPU")
    tmp = tempfile.mkdtemp(prefix="fmh_dryrun_")
    try:
        mp.spawn(_dryrun_rank, nprocs=n_devices, join=True,
                 args=(n_devices, os.path.join(tmp, "rendezvous"), device_type, backend,
                       weights, sampler_kw, tmp))
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(n_devices)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if reports is not None:
        reports.extend(ranks)
    losses = ranks[0]["losses"].numpy()
    tp = 2 if n_devices % 2 == 0 else 1
    print(f"dryrun_multichip ok (dp={n_devices // tp}, tp={tp}, {device_type}, {backend}); "
          f"per-image losses: {losses}")
    return losses
