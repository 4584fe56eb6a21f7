"""Where the inpainting stage (stage 3) spends its time on the GPU.

    python3 -m followmyhold_tpu_torch.tools.profile_inpaint [--image crop.png]

Builds the FLUX.1-Kontext inpainter at full width and depth (FLUX.1-Kontext-dev,
the FLUX VAE, CLIP-L and T5-XXL; bf16, seeded random weights, built on the
card) with synthetic tokenizer vocabularies (so the prompt takes the
checkpoint path: 77 CLIP and 512 T5 ids), and inpaints a crop (``--image``, or
a random 512^2 one) twice: the first call pays one-time set-up (cuBLAS,
cuDNN), the second is timed by part (``timed_parts``): tokenizing, the T5 and
CLIP towers, the VAE encode, the transformer's steps (their span and the
median step), the VAE decode, the PNG. Then one step under torch.profiler:
device time over wall time (the card's busy share), the flash-attention
kernel's and the GEMM library's shares of the device time, the launches, and
the kernels that took the most device time.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from followmyhold_tpu_torch.models.clip_text import ClipTextModel
from followmyhold_tpu_torch.models.flux import FluxTransformer, FluxVae
from followmyhold_tpu_torch.models.t5 import T5Encoder

PARTS = ("tokenize", "text", "vae_encode", "steps", "vae_decode", "png")
# the parts that run on the card, timed with CUDA events (no host
# synchronisation, so the host runs ahead as it does in a user's run); the
# others are host work, timed on the host's clock
DEVICE_PARTS = ("text", "vae_encode", "steps", "vae_decode")
# substrings of the device kernels' names: the port's flash-attention forward
# (K1), and the GEMM library's kernels behind nn.Linear
K1_NAME = "flash_fwd_kernel"
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma")


def _timed(fn, record: dict, key: str):
    def wrapped(*args, **kwargs):
        if key in DEVICE_PARTS:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            record.setdefault(key, []).append((start, end))
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            record.setdefault(key, []).append(time.perf_counter() - t0)
        return out
    return wrapped


@contextlib.contextmanager
def timed_parts(record: dict):
    """Within the block, the stage's parts are wrapped (the functions, not
    changed), each call's timing appended to ``record[part]`` for the parts of
    PARTS ("text": T5 and CLIP; "steps": each transformer call; "png": every
    PIL save): a pair of CUDA events for DEVICE_PARTS, seconds for the
    others. ``summarize_parts`` reads them."""
    from PIL import Image

    from followmyhold_tpu_torch.preprocess import inpaint

    targets = [(inpaint, "tokenize_flux_prompt", "tokenize"), (T5Encoder, "forward", "text"),
               (ClipTextModel, "forward", "text"), (FluxVae, "encode", "vae_encode"),
               (FluxTransformer, "forward", "steps"), (FluxVae, "decode", "vae_decode"),
               (Image.Image, "save", "png")]
    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]
    try:
        for (owner, name, key), (_, _, fn) in zip(targets, originals):
            setattr(owner, name, _timed(fn, record, key))
        yield record
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)


def summarize_parts(record: dict, n_images: int) -> dict:
    """``timed_parts``' record of ``n_images`` images (synchronises the card
    first) -> seconds per image of each part ("steps": each image's steps as
    one span, from its first step's start to its last step's end), the median
    step, each image's steps, the steps an image, and each call's seconds."""
    torch.cuda.synchronize()

    def seconds(t):
        return t[0].elapsed_time(t[1]) / 1e3 if isinstance(t, tuple) else t

    calls = {part: [seconds(t) for t in record.get(part, [])] for part in PARTS}
    out = {part: sum(calls[part]) / n_images for part in PARTS}
    steps = record.get("steps", [])
    n_steps = len(steps) // n_images
    out["steps_per_image"] = [steps[k * n_steps][0].elapsed_time(steps[(k + 1) * n_steps - 1][1])
                              / 1e3 for k in range(n_images)] if n_steps else []
    out["steps"] = sum(out["steps_per_image"]) / n_images
    out["step_median"] = statistics.median(calls["steps"]) if steps else 0.0
    out["n_steps"] = n_steps
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
