"""Where the inpainting stage (stage 3) spends its time on the GPU.

    python3 -m followmyhold_tpu_torch.tools.profile_inpaint [--image crop.png]

Builds the FLUX.1-Kontext inpainter at full width and depth (FLUX.1-Kontext-dev,
the FLUX VAE, CLIP-L and T5-XXL; bf16, seeded random weights, built on the
card) with synthetic tokenizer vocabularies (so the prompt takes the
checkpoint path: 77 CLIP and 512 T5 ids), and inpaints a crop (``--image``, or
a random 512^2 one) twice: the first call pays one-time set-up (cuBLAS,
cuDNN), the second is timed by part from the stage's spans
(``utils.profiling``, read by ``timed_parts``): tokenizing, the T5 and CLIP
towers, the VAE encode, the transformer's steps (their span and the median
step), the VAE decode, the PNG. Then what a span costs the host, without and
inside a profiler session, and one crop under ``utils.profiling.device_trace``;
where ``FOHO_TPU_TRACE_DIR`` is set, its Chrome trace gives each ``flux.step``
span's start against the profiler's range of it on both clocks and the
longest idle gaps of the card, each under the innermost span on the host and
on the device. Last, one step under torch.profiler: device time over wall
time (the card's busy share), the flash-attention kernel's and the GEMM
library's shares of the device time, the launches, and the kernels that took
the most device time.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from followmyhold_tpu_torch.utils import profiling

PARTS = ("tokenize", "text", "vae_encode", "steps", "vae_decode", "png")
# each part's span (utils.profiling); DEVICE_PARTS are read on the device
# clock, the others (host work) on the host's
SPANS = dict(tokenize="inpaint.tokenize", text="inpaint.text", vae_encode="flux.vae_encode",
             steps="flux.step", vae_decode="flux.vae_decode", png="inpaint.png")
DEVICE_PARTS = ("text", "vae_encode", "steps", "vae_decode")
# substrings of the device kernels' names: the port's flash-attention forward
# (K1), and the GEMM library's kernels behind nn.Linear
K1_NAME = "flash_fwd_kernel"
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma")


@contextlib.contextmanager
def timed_parts(record: dict):
    """The stage's spans (``utils.profiling``) that begin within the block,
    collected into ``record["spans"]`` at its end (which synchronises the
    card). ``summarize_parts`` reads them."""
    t0 = profiling.now_ns()
    try:
        yield record
    finally:
        record["spans"] = [r for r in profiling.collect() if r.host_start_ns >= t0]


def summarize_parts(record: dict, n_images: int) -> dict:
    """``timed_parts``' record of ``n_images`` images -> seconds per image of
    each part of PARTS ("text": T5 and CLIP; "steps": each image's steps as
    one span, from its first step's start to its last step's end on the
    device; "png": every PIL save inside ``run``), the median step, each
    image's steps, the steps an image, and each call's seconds. A part is
    its span's interval: "text" holds the ids' copies to the card,
    "vae_encode" the packing, the position ids and the noise, each step its
    Euler update."""
    spans = record.get("spans", [])

    def seconds(part, r):
        return (r.device_ms if part in DEVICE_PARTS else r.host_ms) / 1e3

    calls = {part: [seconds(part, r) for r in spans if r.name == SPANS[part]] for part in PARTS}
    out = {part: sum(calls[part]) / n_images for part in PARTS}
    by_image: dict = {}
    for r in spans:
        if r.name == SPANS["steps"]:
            by_image.setdefault(r.call, []).append(r)
    out["steps_per_image"] = [(steps[-1].device_end_ns - steps[0].device_start_ns) / 1e9
                              for steps in by_image.values()]
    out["steps"] = sum(out["steps_per_image"]) / n_images
    out["step_median"] = statistics.median(calls["steps"]) if calls["steps"] else 0.0
    out["n_steps"] = len(calls["steps"]) // n_images
    out["calls"] = calls
    return out


def profile_call(fn) -> dict:
    """One call of ``fn`` under torch.profiler: wall ms, device ms, the busy
    share, K1's and the GEMM library's device ms, the launches and the top
    kernels' table."""
    fn()                      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]

    def device_ms(pick):
        return sum(e.self_device_time_total for e in kernels if pick(e.key)) / 1e3

    total = device_ms(lambda name: True)
    return dict(wall_ms=wall_ms, device_ms=total, busy=total / wall_ms,
                k1_ms=device_ms(lambda name: K1_NAME in name),
                gemm_ms=device_ms(lambda name: any(s in name.lower() for s in GEMM_NAMES)),
                launches=sum(e.count for e in kernels),
                table=averages.table(sort_by="self_cuda_time_total", row_limit=15,
                                     max_name_column_width=70))


def span_cost_us(n: int = 4096) -> dict:
    """Host microseconds an empty ``utils.profiling.span`` costs on the card's
    stream (two timing events recorded), over ``n`` of them: without a
    profiler session and inside one (``record_function`` too). The ring is
    cleared after."""
    def one_pass() -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("span_cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    one_pass()                                 # warm
    plain = one_pass()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        profiled = one_pass()
    torch.cuda.synchronize()
    profiling.reset()
    return dict(plain=plain, profiled=profiled)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_chrome_trace(path: str) -> dict:
    """A torch.profiler Chrome trace -> {category: [(start_ns, end_ns, name)]}
    sorted, on the spans' clock (Unix-epoch ns: the file's ``ts`` in us after
    its ``baseTimeNanoseconds``)."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    out: dict = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and "dur" in e:
            s = base + round(float(e["ts"]) * 1e3)
            out.setdefault(e.get("cat", ""), []).append((s, s + round(float(e["dur"]) * 1e3),
                                                          e["name"]))
    return {cat: sorted(v) for cat, v in out.items()}


def idle_gaps(trace: dict, span_names, n: int = 10) -> list:
    """The ``n`` longest gaps between the device's operations in ``trace``
    (``read_chrome_trace``), longest first: (ms, the innermost program span
    on the host at the gap's middle, the innermost span on the device there:
    the device-side range of a span runs from its first operation to its
    last). Spans are the ranges named in ``span_names``; "none" where none
    holds the middle."""
    ops = sorted((s, e) for cat in _DEVICE_CATS for s, e, _ in trace.get(cat, ()))
    gaps, end = [], None
    for s, e in ops:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)

    def innermost(ranges, t):
        inside = [(e - s, name) for s, e, name in ranges if s <= t <= e and name in span_names]
        return min(inside)[1] if inside else "none"

    host, device = trace.get("user_annotation", ()), trace.get("gpu_user_annotation", ())
    return [((e - s) / 1e6, innermost(host, (s + e) // 2), innermost(device, (s + e) // 2))
            for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]]


def range_offsets_ms(records, trace: dict, name: str, side: str = "device") -> list:
    """For each span ``name`` of ``records`` (``profiling.collect()``) that
    began inside the traced session, in order, against the k-th range of
    that name in ``trace`` (``read_chrome_trace``): (the span's start less
    the range's, the span's end less the range's), in ms, on ``side``
    "device" (the range the profiler gave its ``record_function`` on the
    device, from its first operation's start to its last one's end) or
    "host"."""
    spans = [r for r in records if r.name == name and r.profiled]
    cat = "gpu_user_annotation" if side == "device" else "user_annotation"
    ranges = [(s, e) for s, e, n in trace.get(cat, ()) if n == name]
    if len(spans) != len(ranges):
        raise ValueError(f"{len(spans)} profiled {name} spans against {len(ranges)} {cat} "
                         f"ranges in the trace")
    return [((getattr(r, f"{side}_start_ns") - s) / 1e6, (getattr(r, f"{side}_end_ns") - e) / 1e6)
            for r, (s, e) in zip(spans, ranges)]


def step_inputs(inpainter, image: np.ndarray, prompt: str, seed: int = 0) -> tuple:
    """The transformer's inputs at the first step of ``image``: (x_in, t5
    states, pooled, t=1, img_ids, txt_ids, guidance 2.5), on the card."""
    from followmyhold_tpu_torch.models.flux import latent_ids, pack_latents
    from followmyhold_tpu_torch.preprocess.inpaint import tokenize_flux_prompt

    dev = inpainter.device
    clip_ids, t5_ids = tokenize_flux_prompt(prompt, inpainter.clip.cfg, inpainter.t5.cfg)
    with torch.no_grad():
        t5 = inpainter.t5(torch.from_numpy(t5_ids).to(dev))
        _, pooled = inpainter.clip(torch.from_numpy(clip_ids).to(dev))
        img = torch.from_numpy(np.asarray(image, np.float32))[None].to(dev) / 255.0
        ctx = pack_latents(inpainter.vae.encode(img * 2.0 - 1.0))
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn(ctx.shape, generator=gen, device=dev)
    h2 = w2 = int(round((ctx.shape[1]) ** 0.5))
    img_ids = torch.from_numpy(np.concatenate([latent_ids(h2, w2, 0),
                                               latent_ids(h2, w2, 1)])).to(dev)
    txt_ids = torch.zeros((t5.shape[1], 3), device=dev)
    one = torch.ones((1,), device=dev)
    return (torch.cat([noise, ctx], dim=1), t5, pooled, one, img_ids, txt_ids, 2.5 * one)


def main() -> None:
    from PIL import Image

    from followmyhold_tpu_torch.preprocess.inpaint import build_inpainter
    from followmyhold_tpu_torch.tools._scene import flux_tokenizer_assets

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--image", default=None, help="a crop to use instead of a random one")
    args = parser.parse_args()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    inpainter = build_inpainter(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in getattr(inpainter, name).parameters()) / 1e9
                for name in ("transformer", "vae", "clip", "t5")}
    print(f"built in {time.perf_counter() - t0:.1f} s: {n_params} billion parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")

    if args.image is not None:
        image = np.asarray(Image.open(args.image).convert("RGB"))
    else:
        image = np.random.default_rng(0).integers(0, 256, (512, 512, 3), dtype=np.uint8)
    prompt = "Remove hands but keep the object."
    with flux_tokenizer_assets():
        for k in range(2):
            record = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with timed_parts(record):
                out = inpainter(image, prompt)
            wall = time.perf_counter() - t0
            parts = summarize_parts(record, 1)
            print(f"image {k}: {wall:.3f} s: " + ", ".join(f"{p} {parts[p]:.4f}" for p in PARTS)
                  + f"; step median {parts['step_median']:.4f} s over {parts['n_steps']} steps; "
                  f"output mean {out.mean():.1f}")
            print(f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        inputs = step_inputs(inpainter, image, prompt)
        cost = span_cost_us()
        print(f"a span costs the host {cost['plain']:.2f} us without a profiler session, "
              f"{cost['profiled']:.2f} us inside one")
        # one crop under the profiler, its spans on the profiler's timelines
        profiling.reset()
        with profiling.device_trace("inpaint_crop"):
            inpainter(image, prompt)
        trace_dir = os.environ.get("FOHO_TPU_TRACE_DIR")
        if trace_dir:
            records = profiling.collect()
            trace = read_chrome_trace(os.path.join(trace_dir, "inpaint_crop.pt.trace.json"))
            steps = [r for r in records if r.name == SPANS["steps"] and r.profiled]

            def lead(r):
                return (r.device_start_ns - r.host_start_ns) / 1e6

            for side in ("device", "host"):
                got = range_offsets_ms(records, trace, SPANS["steps"], side)
                print(f"flux.step's {side} start and end less its profiler range's over "
                      f"{len(got)} steps (ms; the span's device start less its host start): "
                      + ", ".join(f"{a:.4f} {b:.4f} ({lead(r):.3f})"
                                  for (a, b), r in zip(got, steps)))
            names = {r.name for r in records}
            print("the longest idle gaps of the traced crop (ms, host span / device span): "
                  + "; ".join(f"{ms:.3f} {h} / {d}" for ms, h, d in idle_gaps(trace, names)))
    with torch.no_grad():
        prof = profile_call(lambda: inpainter.transformer(*inputs))
    print(prof.pop("table"))
    print(f"one step under the profiler: {prof['wall_ms']:.2f} ms wall, device busy "
          f"{prof['device_ms']:.2f} ms = {prof['busy']:.1%}; K1 {prof['k1_ms']:.2f} ms "
          f"({prof['k1_ms'] / prof['device_ms']:.1%} of device time), GEMM library "
          f"{prof['gemm_ms']:.2f} ms ({prof['gemm_ms'] / prof['device_ms']:.1%}); "
          f"{prof['launches']} launches")


if __name__ == "__main__":
    main()
