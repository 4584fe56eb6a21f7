"""Where MoGe's forward spends its time on the GPU.

    python3 -m followmyhold_tpu_torch.tools.profile_moge [--iters 5] [--size 512]

Builds MoGe at full width (DINOv2-L, the published neck and heads, seeded
random weights) and runs ``moge_infer`` on a random crop at resolution level
9 (a 60x60 grid on a 512^2 crop). It prints the wall time of a call and of
its parts (the encoder, the neck, each head; the resizes and the focal fit are
the rest), each timed by itself with the device synchronised around it, then
one call under torch.profiler: device time over wall time (the card's busy
share), the kernels that took the most device time, and the device launches.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from followmyhold_tpu_torch.geometry.moge import _build_model
from followmyhold_tpu_torch.models.moge import MoGeConfig, moge_infer


def _timed_parts(model):
    """Forward hooks that time each top-level part, synchronised. -> (the
    seconds of each part's calls, the hooks' handles)."""
    seconds, handles = {}, []

    def pre(name):
        def hook(module, args):
            torch.cuda.synchronize()
            seconds.setdefault(name, []).append(-time.perf_counter())
        return hook

    def post(name):
        def hook(module, args, out):
            torch.cuda.synchronize()
            seconds[name][-1] += time.perf_counter()
        return hook

    for name in ("backbone", "neck", "points_head", "mask_head", "normal_head"):
        part = getattr(model, name)
        handles += [part.register_forward_pre_hook(pre(name)),
                    part.register_forward_hook(post(name))]
    return seconds, handles


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--size", type=int, default=512)
    args = parser.parse_args()

    dev = torch.device("cuda:0")
    print(torch.cuda.get_device_name(0))
    model = _build_model(MoGeConfig(), seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    image = torch.rand((1, args.size, args.size, 3), generator=gen, device=dev)

    for _ in range(2):                      # cuDNN's set-up, caches
        moge_infer(model, image)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        moge_infer(model, image)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.iters * 1e3
    print(f"moge_infer at {args.size}^2: {wall_ms:.2f} ms a call (after two warm-up calls)")

    seconds, handles = _timed_parts(model)
    for _ in range(args.iters):
        moge_infer(model, image)
    for handle in handles:
        handle.remove()
    parts = {k: sum(v) / len(v) * 1e3 for k, v in seconds.items()}
    print("parts, each synchronised (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        moge_infer(model, image)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"profiled call: {prof_wall_ms:.2f} ms wall; device busy {device_ms:.2f} ms = "
          f"{device_ms / prof_wall_ms:.1%} of wall; {launches} device launches")
    print(averages.table(sort_by="self_cuda_time_total", row_limit=20,
                         max_name_column_width=70))


if __name__ == "__main__":
    main()
