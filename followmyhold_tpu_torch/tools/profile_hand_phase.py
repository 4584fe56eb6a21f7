"""Where a hand-pose iteration spends its time on the GPU.

    python3 -m followmyhold_tpu_torch.tools.profile_hand_phase [--iters 20]

Runs the guided sampler's hand phase on the synthetic scene at 512x512 (tiny
networks: the phase does not touch them), prints the wall time per iteration,
then the same phase under torch.profiler: device time by kernel and host time
by call. Device time / wall time is the card's busy share.

Host time by the port's function: during the profiled run only, the
rasterizer's and the phase's host-side functions are wrapped in profiler
ranges ``span::<function>`` (a function a checkout lacks is skipped), and
those ranges, the port's ``torch.autograd.Function`` rows (named ``_...``)
and the aten gathers and scatters are listed with their calls and CPU time
per iteration (the profiler's own overhead included, so compare two
checkouts within one run of this tool each, on one machine).
"""

from __future__ import annotations

import argparse
import importlib
import time
from contextlib import contextmanager

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from followmyhold_tpu_torch.configs.guidance import OptimizationConfig
from followmyhold_tpu_torch.diffusion.guidance import GuidedSampler, init_pose
from followmyhold_tpu_torch.geometry.hunyuan import build_models
from followmyhold_tpu_torch.models.hunyuan import COND_TINY, DIT_TINY, VAE_TINY
from followmyhold_tpu_torch.tools._scene import hand_scene


_SPANS = {"followmyhold_tpu_torch.ops.rasterizer": ("rasterize", "bin_and_pack",
                                                     "raster_chunk_plan"),
          "followmyhold_tpu_torch.diffusion.guidance": ("render_normal_and_disparity",
                                                        "vertex_normals")}
_ATEN_ROWS = ("aten::index_select", "aten::index_add_", "cudaLaunchKernel")


@contextmanager
def _spans():
    """Wrap the functions of ``_SPANS`` in ``span::<function>`` profiler ranges."""
    saved = []
    for module_name, names in _SPANS.items():
        module = importlib.import_module(module_name)
        for name in names:
            fn = getattr(module, name, None)
            if fn is None:
                continue

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                with record_function(f"span::{_name}"):
                    return _fn(*args, **kwargs)

            saved.append((module, name, fn))
            setattr(module, name, wrapped)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()

    dev = torch.device("cuda:0")
    dit, vae, _ = build_models(DIT_TINY, VAE_TINY, COND_TINY, device=dev)
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

    with _spans(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sampler._hand_phase(init_pose(dev), targets)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    # kernels only: an operator's row, and a span's device-side range, repeat
    # the time of the kernels they launched
    device_ms = sum(e.self_device_time_total for e in averages
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.key.startswith("span::")) / 1e3 / args.iters
    print(f"device busy {device_ms:.2f} ms per iteration = {device_ms / wall_ms:.1%} of wall")
    print(averages.table(sort_by="self_cuda_time_total", row_limit=15,
                         max_name_column_width=60))
    print(averages.table(sort_by="self_cpu_time_total", row_limit=10,
                         max_name_column_width=60))
    host_ms = sum(e.self_cpu_time_total for e in averages) / 1e3 / args.iters
    print(f"host, profiled: {host_ms:.2f} ms CPU per iteration; by the port's function:")
    rows = [e for e in averages if e.device_type == torch.autograd.DeviceType.CPU
            and (e.key.startswith(("span::", "_")) or e.key in _ATEN_ROWS)]
    for e in sorted(rows, key=lambda e: -e.cpu_time_total):
        print(f"  {e.key}: {e.count / args.iters:.1f} calls, "
              f"{e.cpu_time_total / 1e3 / args.iters:.3f} ms CPU per iteration")


if __name__ == "__main__":
    main()
