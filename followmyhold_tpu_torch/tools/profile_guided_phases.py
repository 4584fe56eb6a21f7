"""Where an object-phase and a joint-phase iteration spend their time on the GPU.

    python3 -m followmyhold_tpu_torch.tools.profile_guided_phases [--iters 5]

Runs the guided sampler's object phase (1.5) and joint phase (2) on the
synthetic scene at 512x512 with the full-width ShapeVAE (seeded random
weights; the DiT is not called by these phases, so it is the tiny one). For
each phase it prints the wall time per iteration of three runs (the host's
spread between them; the first one's in the summary line) and the host syncs
per iteration, then the same phase under
torch.profiler: device time per iteration over wall time (the card's busy
share), the kernels that took the most device time, the CUDA kernels launched
per iteration and the launches of the port's own kernels per iteration.
"""

from __future__ import annotations

import argparse
import time
import warnings

import torch
from torch.profiler import ProfilerActivity, profile

from followmyhold_tpu_torch.configs.guidance import OptimizationConfig, guidance_mesh_caps
from followmyhold_tpu_torch.diffusion.guidance import GuidedSampler, init_pose
from followmyhold_tpu_torch.geometry.hunyuan import build_models
from followmyhold_tpu_torch.models.hunyuan import COND_TINY, DIT_TINY, VAE_FULL
from followmyhold_tpu_torch.ops import _kernels
from followmyhold_tpu_torch.tools._scene import hand_scene


def _count_syncs(fn) -> int:
    """How often fn synchronises the host with the device (torch's sync debug
    mode warns once per synchronising call)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message).lower() for w in caught)


def _profile_phase(name: str, run, iters: int) -> None:
    run()                                   # build + warm up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / iters * 1e3)
    wall_ms = walls[0]
    print(f"{name}: wall ms per iteration of each run: {walls}; host syncs per iteration: "
          f"{_count_syncs(run) / iters:.1f}")
    _kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ours = {k: v / iters for k, v in _kernels.launch_counts().items()}
    averages = prof.key_averages()
    # kernels only: an operator's row repeats the time of the kernels it launched
    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    launches = sum(e.count for e in kernels) / iters
    print(f"{name}: {wall_ms:.2f} ms wall per iteration; device busy {device_ms:.2f} ms "
          f"= {device_ms / wall_ms:.1%} of wall; {launches:.0f} device launches per "
          f"iteration; the port's kernels per iteration: {ours}")
    print(averages.table(sort_by="self_cuda_time_total", row_limit=15,
                         max_name_column_width=60))
    print(averages.table(sort_by="self_cpu_time_total", row_limit=10,
                         max_name_column_width=60))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args()

    dev = torch.device("cuda:0")
    print(torch.cuda.get_device_name(0))
    dit, vae, _ = build_models(DIT_TINY, VAE_FULL, COND_TINY, seed=0, device=dev)
    _, _, camera, targets = hand_scene(dev)
    config = OptimizationConfig(optimization_steps_scale=args.iters,
                                optimization_steps_joint=args.iters)
    sampler = GuidedSampler(dit, vae, camera, config, **guidance_mesh_caps())
    gen = torch.Generator(device=dev).manual_seed(2)
    shape = (1, VAE_FULL.num_latents, VAE_FULL.embed_dim)
    latents = torch.randn(shape, generator=gen, device=dev)
    noise = torch.randn(shape, generator=gen, device=dev)
    sched = sampler._schedule(config.num_inference_steps)
    i_obj = config.handopt_start_step + 1
    hand, obj = init_pose(dev), init_pose(dev)

    _profile_phase("object phase", lambda: sampler._obj_phase(
        obj, noise, latents, targets, sched, i_obj), args.iters)
    _profile_phase("joint phase (near the end)", lambda: sampler._joint_phase(
        hand, obj, noise, latents, targets, sched, config.num_inference_steps - 1,
        near_end=True), args.iters)


if __name__ == "__main__":
    main()
