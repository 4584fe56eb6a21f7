"""Where a hand-pose iteration spends its time on the GPU.

    python3 -m followmyhold_tpu_torch.tools.profile_hand_phase [--iters 20]

Runs the guided sampler's hand phase on the synthetic scene at 512x512 (tiny
networks: the phase does not touch them), prints the wall time per iteration,
then the same phase under torch.profiler: device time by kernel and host time
by call. Device time / wall time is the card's busy share.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from followmyhold_tpu_torch.configs.guidance import OptimizationConfig
from followmyhold_tpu_torch.diffusion.guidance import GuidedSampler, init_pose
from followmyhold_tpu_torch.geometry.hunyuan import build_models
from followmyhold_tpu_torch.models.hunyuan import DIT_TINY, VAE_TINY
from followmyhold_tpu_torch.tools._scene import hand_scene


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()

    dev = torch.device("cuda:0")
    dit, vae = build_models(DIT_TINY, VAE_TINY, device=dev)
    _, _, camera, targets = hand_scene(dev)
    config = OptimizationConfig(optimization_steps_hand=args.iters,
                                optimization_steps_scale=0, optimization_steps_joint=0)
    sampler = GuidedSampler(dit, vae, camera, config)
    sampler._hand_phase(init_pose(dev), targets)            # build + warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler._hand_phase(init_pose(dev), targets)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.iters * 1e3
    print(f"{torch.cuda.get_device_name(0)}: {wall_ms:.2f} ms wall per hand iteration")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sampler._hand_phase(init_pose(dev), targets)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    # kernels only: an operator's row repeats the time of the kernels it launched
    device_ms = sum(e.self_device_time_total for e in averages
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / args.iters
    print(f"device busy {device_ms:.2f} ms per iteration = {device_ms / wall_ms:.1%} of wall")
    print(averages.table(sort_by="self_cuda_time_total", row_limit=15,
                         max_name_column_width=60))
    print(averages.table(sort_by="self_cpu_time_total", row_limit=10,
                         max_name_column_width=60))


if __name__ == "__main__":
    main()
