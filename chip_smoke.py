#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py               # everything (what a checkout is judged by)
    python3 chip_smoke.py --kernels-only  # build + kernel checks, no models

Phases, each printing one line; any failure ends the run with a non-zero code:

1. device   require CUDA; print the card's name and power limit.
2. build    compile the CUDA kernels from followmyhold_tpu_torch/csrc with nvcc;
            ptxas must report no spills and no serialised wgmma; build the native
            host library (followmyhold_tpu_torch/native, g++).
3. kernels  call every kernel's wrapper at the shapes the main path gives it
            and hold the result against its plain PyTorch version on the same
            inputs; time kernel, plain version and, for attention, PyTorch's
            scaled_dot_product_attention as a yardstick (the port never calls it).
            Also the deterministic scatter-add behind every gather's gradient
            (ops/indexing.scatter_rows_add): no host sync, same bits in two
            calls, timed beside the atomic index_add_ it replaced.
4. inpaint  stage 3 first, as the pipeline runs it: preprocess/inpaint.run on the two
            synthetic HOI crops and hand masks that stages 4-8 use, with FLUX.1-Kontext-dev,
            the FLUX VAE, CLIP-L and T5-XXL at full width and depth (bf16, seeded random
            weights built on the card, ~31.5 GiB) and synthetic tokenizer vocabularies, so
            that the prompt takes the checkpoint's path (77 CLIP and 512 T5 ids): 28 steps
            an image with K1 at [1,24,2560,128], 57 launches a step. Its own launch counts;
            each {id}_inpainted_{rid}.png checked; the final latents finite; two 2-step
            kontext_edit calls must give the same bits; one full-width transformer forward
            with K1 held against the plain attention; s per image by part (tokenizing, T5
            and CLIP, VAE encode, the steps as one span and the median step, VAE decode,
            the PNG; the card's parts on CUDA events, with no host synchronisation added)
            and peak memory. The models are freed before stage 4. After the batched stage
            (7), the last timed one, one step of a freshly built inpainter runs under
            torch.profiler: its device-busy share, K1's and the GEMM library's shares (a
            profiler session leaves the process's launches slower).
5. stages   stages 4-8 on two synthetic HOI crops (write_stage_inputs' hoi_ids; a
            left and a right hand), as a user runs them, with the full-width models.
            First stage 4, geometry/moge.run on the crops without background:
            MoGe with DINOv2-L (24 x 1024, bf16) and the published neck and heads at
            resolution level 9 (a 60x60 grid: K1 at [1,16,3601,64], 24 launches a
            crop), its head outputs shaped into a scene (see _shape_moge), with its
            own launch counts, s per image by part, moge_infer's host syncs and
            every file checked. Then geometry/hunyuan.run (both images in one batch
            through 30 CFG DiT steps, K1 at [4,16,4442,128]; each through the 384^3
            export and the post-processing; the field's logit level set for this
            stage's latents, see _stage5_level), hand/hamer.run (ViT-H HaMeR, bf16,
            with the overlay through K3), alignment/h2m.run against stage 4's meshes
            and alignment/mano.run. The launch counts are set to 0 just before and
            read just after; it prints s per image split by part and the ICP's host
            synchronisations, holds K3 against its plain version on the overlay's
            render, and feeds image 0's files, stage 4's mesh and field of view
            among them, to guidance/run.build_targets (its time and transient
            memory).
6. main     the guidance stage on one image, as a user runs it: guidance/run.py's
            run_hunyuan_w_guid on synthetic artifacts (a 512^2 crop, masks, a 384x512
            MoGe grid mesh, the synthetic hand, keypoints), with the full-width
            Hunyuan3D-2 DiT, ShapeVAE and DINOv2-G conditioner on seeded random
            weights (the ShapeVAE's field shaped to an object-sized surface, see
            _shape_field). First the conditioner with K1 is held against the plain
            attention, and two calls of GuidedSampler.run with a reduced config
            (every phase, a few steps each) must give the same bits. Then the stage
            with the default OptimizationConfig: build_targets (the MoGe render),
            the conditioner, GuidedSampler.run (20 CFG steps; 200 hand-pose Adam
            steps, 100 object-phase and 9 x 50 joint-phase AdamW steps, each through
            the ShapeVAE decode and its backward, marching tets, render and losses),
            the 384^3 export (two-level decode on the card, compose and marching
            tets on the host), floaters, degenerate faces, face reduction, and the
            two PLYs. The kernels' launch counts are set to 0 just before the stage
            and read just after; it prints s per image split by part.
7. batch    the guidance stage on two images in one batch: guidance/run.run with
            batch_size=2 over two scenes at 50 and 70 degrees, with the same models
            and the default config (GuidedSampler.run_batch: the DiT at batch 4, the
            phases image by image; the exports two at once), with its own launch
            counts; checks all four PLYs, that the two poses differ, and each
            image's batched DiT prediction against its batch-2 one.
8. result   a `kernels` JSON line (`launches`: the guidance stage's run of one
            image; `launches_stage_3`, `launches_stage_4`, `launches_stages_5_8`,
            `launches_batched`: the runs of stage 3, of stage 4, of stages 5-8 and of the
            batched stage), the nvidia-smi line, and the `ok` JSON line.

Tolerances, and why:
- flash attention O (bf16): 1e-2 * max|ref| + 1e-3. The kernel rounds the
  unnormalised probabilities to bf16 before the second product and divides by
  the row sum afterwards; the plain version normalises first. Both then round
  O to bf16 (relative 2^-8). That bound alone could pass a kernel that drops
  one kv tile, so O is also held to ||O - ref||_F <= 2^-8 ||ref||_F (one bf16
  rounding step of the whole tensor), and the script checks in every run
  that this limit rejects the plain O with one 32-row kv tile left out. Two
  calls must give the same bits (no atomics), and the checked call follows a
  call on other inputs, whose freed outputs the allocator hands to it: a row
  the kernel fails to write then holds a wrong O and lse. A ragged D=64
  shape runs the masks; D=80 and D=72 run the wrapper's zero padding to 128.
- flash attention logsumexp (f32): 2e-3 absolute: exp2/log in another order
  and f32 sums over up to 4442 columns.
- flash attention backward (dq f32, dk and dv bf16): 2e-2 * max|ref| + 1e-3
  against the plain version on the same inputs, which rounds p and ds to bf16
  where the kernel does. The sums over up to 8192 rows run in another order
  (tensor-core f32 accumulators against torch's matmuls), and dk and dv are
  rounded to bf16 on both sides (relative 2^-8), so one rounding step of the
  largest entry is the scale of the difference. That bound alone could pass a
  kernel that drops one query or kv tile of a sum, so each gradient is also
  held to ||got - ref||_F <= 2^-8 ||ref||_F (one bf16 rounding step of the
  whole tensor; the kernels read 3e-5 to 3e-4), and the script checks that
  this limit rejects the plain gradients with one 32-row tile (the smallest of
  either design) left out of their sums (they read 6e-2 to 1.2e-1). Neither
  pass uses atomics, so dk and dv must be bit-identical with and without the
  dq pass, and two calls on the same inputs must give the same bits. A ragged
  shape (N, M not multiples of 64) runs the masks.
- the conditioner's tokens (bf16, 40 layers): ||with K1 - with the plain
  attention||_F <= 2^-6 ||plain||_F. Each layer's attention differs by K1's
  ~2.9e-3 and the differences compound through the residual stream; measured
  7.8e-3 on one H100, and the limit is twice that.
- stage 3's transformer (bf16, 57 blocks, at its first step on image 0):
  ||with K1 - with the plain attention||_F <= 2.5e-2 ||plain||_F, twice the
  1.25e-2 measured on one H100 (each block's attention differs by K1's
  ~2.9e-3, compounding through the residual stream). Two 2-step kontext_edit
  calls on the same inputs must give the same bits (no atomics on the path).
- rasterizer forward: winner slots must agree on all but 0.1 % of the pixels
  (the arithmetic is bit-identical by construction; the margin is for depth
  ties, and for the kernels' cull: they skip the (pixel, face) pairs beyond a
  face's padded bounding box, which the plain version evaluates, and the two
  differ where rounding puts such a pixel "inside" a sliver face). Where they
  agree, w1, w2 to 1e-5 and vis to 1e-4 (the visibility product is taken in
  another order). The counts of pixels that differ are printed. The chunk
  plan that the kernels run on must equal its plain version. Checked at the
  hand, object and MoGe shapes and on stage 6's overlay, forward and
  backward: two calls give the same bits, and the checked call follows a call
  on other inputs of the same shapes, so a pixel or a dgeom column the
  kernels leave unwritten holds another value.
- rasterizer backward: 2e-2 * max|ref| against autograd of the plain version
  (the tolerance of the reference's own kernel test), and all but 1 % of the
  entries within 1e-4 * max|ref|. Nearly every entry agrees to summation order.
  The wide bound is for pixels whose centre lies within float32 rounding of an
  edge's line: there the offset from the nearest point is rounding noise, so its
  direction is arbitrary; the closed form drops the (analytically zero)
  derivative through the nearest point's parameter while autograd keeps its
  rounding residue. Against a float64 run both float32 versions are off by the
  same order at those pixels.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# published peaks of one H100 SXM (dense)
_BF16_FLOPS = 989e12
_F32_FLOPS = 67e12
_HBM_BYTES = 3.35e12
# f32 operations per (pixel, face) pair, counted from the first kernels' arithmetic
# and kept, so that bounds compare across versions
_RASTER_FWD_OPS = 90
_RASTER_BWD_OPS = 170


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, warmup: int, iters: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
# kernel checks
# --------------------------------------------------------------------------- #

# relative Frobenius limit of the forward's O (one bf16 rounding step of the
# whole tensor), and the kv rows of the tile whose omission it must catch
_FWD_REL_LIMIT = 2.0 ** -8
_FWD_FAULT_ROWS = 32


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def check_flash_attention(dev) -> dict:
    from followmyhold_tpu_torch.ops import attention as A
    from followmyhold_tpu_torch.tools.time_raster_kernels import time_call

    shapes = [  # (label, B, H, N, M, D); the first has most launches on the main path
        ("vae_self", 1, 16, 3072, 3072, 64),
        ("geo_cross", 4, 16, 8192, 3072, 64),
        ("dit_joint", 2, 16, 4442, 4442, 128),
        ("dit_batch", 4, 16, 4442, 4442, 128),   # the Hunyuan stage: two images with CFG
        ("cond_self", 1, 24, 1370, 1370, 64),  # DINOv2-G's 40 self-attentions (ragged)
        ("moge_self", 1, 16, 3601, 3601, 64),  # MoGe's DINOv2-L, 24 a crop (ragged)
        ("flux_joint", 1, 24, 2560, 2560, 128),  # FLUX.1-Kontext, 57 a step (stage 3)
        ("ragged", 1, 16, 3000, 2900, 64),   # the kv mask, zero-filled rows, rows past N
        ("d80", 1, 16, 1024, 1024, 80),      # head sizes padded to 128 by the wrapper
        ("d72", 1, 16, 1024, 1024, 72),
    ]
    per_shape = []
    for label, B, H, N, M, D in shapes:
        gen = torch.Generator(device=dev).manual_seed(N + D)
        q = (torch.randn((B, H, N, D), generator=gen, device=dev) * 2.0).bfloat16()
        k = torch.randn((B, H, M, D), generator=gen, device=dev).bfloat16()
        v = torch.randn((B, H, M, D), generator=gen, device=dev).bfloat16()
        scale = 1.0 / math.sqrt(D)
        with torch.no_grad():
            # a call on other inputs first: the allocator hands its freed blocks
            # to the checked call, so a row that call fails to write holds
            # another O and lse, not a correct one
            poison = A.flash_attention_forward(-q, k, v, scale)
            del poison
            out, lse = A.flash_attention_forward(q, k, v, scale)
            again = A.flash_attention_forward(q, k, v, scale)
            torch.cuda.synchronize()
            wrong = []
            if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
                wrong.append("two calls on the same inputs differ")  # no atomics
            del again
            ref, ref_lse = A.flash_attention_plain(q, k, v, scale)
            err_o = (out.float() - ref.float()).abs().max().item()
            rel = _rel_err(out, ref)
            err_l = (lse - ref_lse).abs().max().item()
            tol_o = 1e-2 * ref.float().abs().max().item() + 1e-3
            if not (math.isfinite(err_o) and err_o <= tol_o and rel <= _FWD_REL_LIMIT):
                wrong.append(f"O max |diff| {err_o} (tolerance {tol_o}), relative {rel} "
                             f"(limit {_FWD_REL_LIMIT})")
            if not (math.isfinite(err_l) and err_l <= 2e-3):
                wrong.append(f"logsumexp differs by {err_l} (tolerance 2e-3)")
            # the limit must reject O without one kv tile (rows [b, b + 32))
            b = M // 2 // 64 * 64
            kept = torch.cat([torch.arange(b, device=dev),
                              torch.arange(b + _FWD_FAULT_ROWS, M, device=dev)])
            fault = _rel_err(A.flash_attention_plain(q, k[:, :, kept], v[:, :, kept], scale)[0],
                             ref)
            if not fault > _FWD_REL_LIMIT:
                wrong.append(f"the relative limit passes O without one {_FWD_FAULT_ROWS}-row "
                             f"kv tile ({fault})")
            if wrong:
                fail(f"flash attention {label}: " + "; ".join(wrong))
            del ref, ref_lse
            ms = cuda_ms(lambda: A.flash_attention_forward(q, k, v, scale), 2, 10)
            graph_ms = time_call(lambda: A.flash_attention_forward(q, k, v, scale))["graph_ms"]
            plain_ms = cuda_ms(lambda: A.flash_attention_plain(q, k, v, scale), 1, 2)
            lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=scale), 2, 10)
        flops = 4.0 * B * H * N * M * D
        nbytes = 2.0 * B * H * D * (2 * N + 2 * M) + 4.0 * B * H * N
        t_ops, t_bytes = flops / _BF16_FLOPS * 1e3, nbytes / _HBM_BYTES * 1e3
        per_shape.append(dict(
            shape=label, dims=[B, H, N, M, D], max_abs_err=err_o, rel_err=rel,
            rel_err_one_tile_missing=fault, lse_max_abs_err=err_l,
            ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
            tflops=flops / ms / 1e9))
        say(f"kernel flash_attention_fwd {label} {[B, H, N, M, D]}: err_O {err_o:.3e} relative "
            f"{rel:.2e} (limit {_FWD_REL_LIMIT:.2e}; one kv tile missing {fault:.2e}) err_lse "
            f"{err_l:.3e}; same bits in two calls; kernel {ms:.3f} ms (graph replay "
            f"{graph_ms:.3f}; {flops / ms / 1e9:.0f} TFLOP/s, {ms / lib_ms:.2f}x sdpa) plain "
            f"{plain_ms:.3f} ms "
            f"sdpa {lib_ms:.3f} ms bound {max(t_ops, t_bytes):.3f} ms")
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    head = per_shape[0]
    return dict(name="flash_attention_fwd", route="cuda",
                source="followmyhold_tpu_torch/csrc/flash_attention_fwd.cu",
                replaces="followmyhold_tpu/ops/attention.py:108",
                max_abs_err=max(s["max_abs_err"] for s in per_shape),
                ms=head["ms"], graph_ms=head["graph_ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], shapes=per_shape)


def _plain_backward_by_slice(A, q, k, v, do, lse, dsum, scale):
    """The plain backward one batch slice at a time: its f32 [H,N,M]
    temporaries of the whole geo batch would not fit beside the inputs."""
    parts = [A.flash_attention_backward_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                              do[b:b + 1], lse[b:b + 1], dsum[b:b + 1], scale)
             for b in range(q.shape[0])]
    return tuple(torch.cat(xs) for xs in zip(*parts))


# relative Frobenius limit of the backward's gradients (one bf16 rounding
# step of the whole tensor), and the rows of the tile whose omission it must catch
_BWD_REL_LIMIT = 2.0 ** -8
_BWD_FAULT_ROWS = 32


def _one_tile_fault(A, q, k, v, do, lse, dsum, scale, ref) -> dict:
    """The relative error of gradients that miss one tile of their sums: dk and
    dv without query rows [a, a + 32), dq without kv rows [b, b + 32). That
    tile's share is the plain backward of those rows alone."""
    a, b = q.shape[2] // 2 // 64 * 64, k.shape[2] // 2 // 64 * 64
    rq, rk = slice(a, a + _BWD_FAULT_ROWS), slice(b, b + _BWD_FAULT_ROWS)
    _, dk_t, dv_t = A.flash_attention_backward_plain(
        q[:, :, rq], k, v, do[:, :, rq], lse[:, :, rq], dsum[:, :, rq], scale)
    dq_t, _, _ = A.flash_attention_backward_plain(q, k[:, :, rk], v[:, :, rk], do, lse, dsum,
                                                  scale)
    return {name: (part.float().norm() / want.float().norm()).item()
            for name, part, want in zip(("dq", "dk", "dv"), (dq_t, dk_t, dv_t), ref)}


def check_flash_attention_backward(dev) -> dict:
    from followmyhold_tpu_torch.ops import attention as A

    shapes = [  # (label, B, H, N, M, D); the first has most launches on the main path
        ("vae_self", 1, 16, 3072, 3072, 64),
        ("geo_cross", 4, 16, 8192, 3072, 64),
        ("dit_joint", 2, 16, 4442, 4442, 128),
        ("ragged", 1, 16, 3000, 2900, 64),   # every mask of the D=64 design
        ("d80", 1, 16, 1024, 1024, 80),      # head sizes padded to 128 by the wrapper
        ("d72", 1, 16, 1024, 1024, 72),
    ]
    per_shape = []
    for label, B, H, N, M, D in shapes:
        gen = torch.Generator(device=dev).manual_seed(N + D + 1)
        q = (torch.randn((B, H, N, D), generator=gen, device=dev) * 2.0).bfloat16()
        k = torch.randn((B, H, M, D), generator=gen, device=dev).bfloat16()
        v = torch.randn((B, H, M, D), generator=gen, device=dev).bfloat16()
        do = torch.randn((B, H, N, D), generator=gen, device=dev).bfloat16()
        scale = 1.0 / math.sqrt(D)
        with torch.no_grad():
            out, lse = A.flash_attention_forward(q, k, v, scale)
            dsum = (do.float() * out.float()).sum(-1)
            dq, dk, dv = A.flash_attention_backward(q, k, v, do, lse, dsum, scale)
            _, dk_nq, dv_nq = A.flash_attention_backward(q, k, v, do, lse, dsum, scale,
                                                         need_dq=False)
            torch.cuda.synchronize()
            wrong = []
            if not (torch.equal(dk, dk_nq) and torch.equal(dv, dv_nq)):
                wrong.append("dk/dv change when the dq pass is skipped")
            # no atomics in either pass: a second call gives the same bits
            again = A.flash_attention_backward(q, k, v, do, lse, dsum, scale)
            if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)):
                wrong.append("two calls on the same inputs differ")
            del again
            ref = _plain_backward_by_slice(A, q, k, v, do, lse, dsum, scale)
            fault = _one_tile_fault(A, q, k, v, do, lse, dsum, scale, ref)
            errs, rel = {}, {}
            for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                errs[name] = (got.float() - want.float()).abs().max().item()
                rel[name] = _rel_err(got, want)
                tol = 2e-2 * want.float().abs().max().item() + 1e-3
                if not (math.isfinite(errs[name]) and errs[name] <= tol
                        and rel[name] <= _BWD_REL_LIMIT):
                    wrong.append(f"{name} max |diff| {errs[name]} (tolerance {tol}), relative "
                                 f"{rel[name]} (limit {_BWD_REL_LIMIT})")
                if not fault[name] > _BWD_REL_LIMIT:
                    wrong.append(f"the relative limit passes {name} without one "
                                 f"{_BWD_FAULT_ROWS}-row tile ({fault[name]})")
            if wrong:
                fail(f"flash backward {label}: " + "; ".join(wrong))
            del ref
            ms = cuda_ms(lambda: A.flash_attention_backward(q, k, v, do, lse, dsum, scale), 2, 10)
            ms_no_dq = cuda_ms(lambda: A.flash_attention_backward(
                q, k, v, do, lse, dsum, scale, need_dq=False), 2, 10)
            plain_ms = cuda_ms(lambda: _plain_backward_by_slice(
                A, q, k, v, do, lse, dsum, scale), 1, 2)
        # the library's backward alone: one forward, then its backward timed
        qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, scale=scale)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do,
                                                     retain_graph=True), 2, 10)
        del qg, kg, vg, sdpa_out
        product = 2.0 * B * H * N * M * D
        flops, flops_no_dq = 5 * product, 4 * product   # dq adds dS K
        nbytes_no_dq = (2.0 * B * H * D * (2 * N + 2 * M)   # q, do, k, v in
                        + 4.0 * B * H * N * 2               # lse, dsum in
                        + 2.0 * B * H * M * D * 2)          # dk, dv out
        nbytes = nbytes_no_dq + 4.0 * B * H * N * D         # dq out (f32)
        t_ops, t_bytes = flops / _BF16_FLOPS * 1e3, nbytes / _HBM_BYTES * 1e3
        bound_no_dq = max(flops_no_dq / _BF16_FLOPS, nbytes_no_dq / _HBM_BYTES) * 1e3
        per_shape.append(dict(
            shape=label, dims=[B, H, N, M, D], max_abs_err=max(errs.values()),
            errs=errs, rel_errs=rel, rel_errs_one_tile_missing=fault, ms=ms,
            ms_without_dq=ms_no_dq, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            bound_ms_without_dq=bound_no_dq,
            tflops=flops / ms / 1e9, tflops_without_dq=flops_no_dq / ms_no_dq / 1e9))
        say(f"kernel flash_attention_bwd {label} {[B, H, N, M, D]}: err dq {errs['dq']:.3e} "
            f"dk {errs['dk']:.3e} dv {errs['dv']:.3e}, relative dq {rel['dq']:.2e} dk "
            f"{rel['dk']:.2e} dv {rel['dv']:.2e} (limit {_BWD_REL_LIMIT:.2e}; one tile missing: "
            f"dq {fault['dq']:.2e} dk {fault['dk']:.2e} dv {fault['dv']:.2e}); kernel {ms:.3f} ms "
            f"({flops / ms / 1e9:.0f} TFLOP/s, {ms / lib_ms:.2f}x sdpa backward), without dq "
            f"{ms_no_dq:.3f} ms ({flops_no_dq / ms_no_dq / 1e9:.0f} TFLOP/s, "
            f"{ms_no_dq / lib_ms:.2f}x); plain {plain_ms:.3f} ms, sdpa backward {lib_ms:.3f} ms; "
            f"bound {max(t_ops, t_bytes):.3f} ms, without dq {bound_no_dq:.3f} ms")
        del q, k, v, do, out, lse, dsum, dq, dk, dv, dk_nq, dv_nq
        torch.cuda.empty_cache()
    head = per_shape[0]
    return dict(name="flash_attention_bwd", route="cuda",
                source="followmyhold_tpu_torch/csrc/flash_attention_bwd.cu",
                replaces="followmyhold_tpu/ops/attention.py:216",
                max_abs_err=max(s["max_abs_err"] for s in per_shape),
                ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"],
                ms_without_dq=head["ms_without_dq"],
                bound_ms_without_dq=head["bound_ms_without_dq"], shapes=per_shape)


def _tile_inputs(camera, verts, faces, faces_per_tile):
    """The packed tile inputs (TileInputs) that rasterize() hands to the kernels."""
    from followmyhold_tpu_torch.ops.rasterizer import bin_and_pack

    return bin_and_pack(camera, verts, faces, torch.ones(faces.shape[0], device=verts.device),
                        0.7, faces_per_tile)


def _raster_pairs(geom, tile_start, meta) -> tuple:
    """(all pairs, pairs within reach): every binned (pixel, face) pair of the
    lists, and those the kernels evaluate, inside the face's bounding box padded
    by the reach (non-degenerate faces only)."""
    counts = (tile_start[1:] - tile_start[:-1]).long()
    T = counts.numel()
    tile_of = torch.repeat_interleave(torch.arange(T, device=geom.device), counts)
    x, y = geom[[0, 3, 6]], geom[[1, 4, 7]]
    area = (x[1] - x[0]) * (y[2] - y[0]) - (y[1] - y[0]) * (x[2] - x[0])
    x0 = ((tile_of % meta.tiles_x) * 16).float()
    y0 = ((tile_of // meta.tiles_x) * 16).float()
    r = meta.reach
    w = ((torch.floor(x.amax(0) + r) - x0).clamp(max=15)
         - (torch.ceil(x.amin(0) - r) - x0).clamp(min=0) + 1).clamp(min=0)
    h = ((torch.floor(y.amax(0) + r) - y0).clamp(max=15)
         - (torch.ceil(y.amin(0) - r) - y0).clamp(min=0) + 1).clamp(min=0)
    near = (w * h * (area.abs() >= 1e-12).float()).double().sum().item()
    return float(counts.sum().item()) * 256.0, near


def _raster_bound(tile_start, pairs: float, n_ops: int, n_column_bytes: int,
                  n_pixel_bytes: int) -> tuple:
    """Least time for this run's lists: every (tile, face) column of 9 floats and
    every pixel's values move once; every evaluated (pixel, face) pair costs n_ops."""
    columns = float((tile_start[1:] - tile_start[:-1]).double().sum().item())
    T = tile_start.numel() - 1
    nbytes = columns * n_column_bytes + T * 256.0 * n_pixel_bytes
    t_ops, t_bytes = pairs * n_ops / _F32_FLOPS * 1e3, nbytes / _HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _shifted(geom, px: float):
    """Other inputs of the same shape: every face moved by px pixels in x and y."""
    other = geom.clone()
    other[[0, 1, 3, 4, 6, 7]] += px
    return other


def _check_raster_shape(R, tag, packed, gen, plain_iters: int = 2) -> tuple:
    """K3 and K4 at one shape: each held against the plain version (forward)
    and autograd of it (backward), two calls giving the same bits, and the
    checked call run right after a call on other inputs of the same shapes,
    whose freed outputs the allocator hands to it, so that a pixel or a dgeom
    column the kernels fail to write holds another value. The plain version is
    timed over ``plain_iters`` calls after one warm-up (0: none)."""
    from followmyhold_tpu_torch.tools.time_raster_kernels import time_call

    geom, tile_start, meta = packed.geom, packed.tile_start, packed.meta
    other = R.raster_tiles_forward(_shifted(geom, 3.5), tile_start, meta)
    del other
    got = R.raster_tiles_forward(geom, tile_start, meta)
    again = R.raster_tiles_forward(geom, tile_start, meta)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"raster forward {tag}: two calls on the same inputs differ")
    del again
    geom_p = geom.clone().requires_grad_(True)
    ref = R.raster_tiles_plain(geom_p, tile_start, meta)
    cmp = _compare_forward(tag, got, ref)

    gw1, gw2, gvis = (torch.randn(got[0].shape, generator=gen, device=geom.device)
                      for _ in range(3))
    other = R.raster_tiles_backward(_shifted(geom, 3.5), tile_start, got[2], got[3], -gw2, gvis,
                                    gw1, meta)
    del other
    dgeom = R.raster_tiles_backward(geom, tile_start, got[2], got[3], gw1, gw2, gvis, meta)
    again = R.raster_tiles_backward(geom, tile_start, got[2], got[3], gw1, gw2, gvis, meta)
    torch.cuda.synchronize()
    if not torch.equal(dgeom, again):
        fail(f"raster backward {tag}: two calls on the same inputs differ")
    del again
    (ref_dgeom,) = torch.autograd.grad(
        (ref[0] * gw1).sum() + (ref[1] * gw2).sum() + (ref[3] * gvis).sum(), geom_p)
    ref_max = ref_dgeom.abs().max().item()
    diff_b = (dgeom - ref_dgeom).abs()
    err_b = diff_b.max().item()
    loose_b = (diff_b > 1e-4 * ref_max + 1e-6).float().mean().item()
    if not (math.isfinite(err_b) and err_b <= 2e-2 * ref_max and loose_b <= 1e-2):
        fail(f"raster backward {tag}: dgeom differs by {err_b} (max|ref| {ref_max}), "
             f"{loose_b:.2%} of the entries beyond 1e-4 of the maximum")
    del ref, ref_dgeom, geom_p

    # ms per wrapper call (chunk plan and kernels) run eagerly, as the main path
    # runs it, which holds the host's share of a call where that is the larger;
    # graph_ms from the replay of a CUDA graph, the device's time alone
    fwd_t = time_call(lambda: R.raster_tiles_forward(geom, tile_start, meta))
    bwd_t = time_call(lambda: R.raster_tiles_backward(
        geom, tile_start, got[2], got[3], gw1, gw2, gvis, meta))
    fwd_ms, bwd_ms = fwd_t["eager_ms"], bwd_t["eager_ms"]
    warm = 1 if plain_iters > 1 else 0
    with torch.no_grad():
        plain_fwd_ms = cuda_ms(lambda: R.raster_tiles_plain(geom, tile_start, meta), warm,
                               plain_iters)

    def plain_fwd_bwd():
        g = geom.clone().requires_grad_(True)
        o = R.raster_tiles_plain(g, tile_start, meta)
        torch.autograd.grad((o[0] * gw1).sum() + (o[1] * gw2).sum() + (o[3] * gvis).sum(), g)

    # the plain backward alone: forward + backward, less the forward timed above
    plain_bwd_ms = cuda_ms(plain_fwd_bwd, warm, plain_iters) - plain_fwd_ms
    pairs, near = _raster_pairs(geom, tile_start, meta)
    fwd_bound, fwd_by = _raster_bound(tile_start, near, _RASTER_FWD_OPS, 36, 16)
    bwd_bound, bwd_by = _raster_bound(tile_start, near, _RASTER_BWD_OPS, 72, 20)
    fwd_all, _ = _raster_bound(tile_start, pairs, _RASTER_FWD_OPS, 36, 16)
    bwd_all, _ = _raster_bound(tile_start, pairs, _RASTER_BWD_OPS, 72, 20)
    counts = (tile_start[1:] - tile_start[:-1]).long()
    plan = _check_chunk_plan(R, tag, tile_start, geom.shape[1])
    common = dict(faces=int(packed.tri.shape[0]), columns=int(geom.shape[1]),
                  longest_list=int(counts.max().item()), chunks=plan["chunks"],
                  pixel_face_pairs=pairs, pairs_after_cull=near)
    fwd = dict(common, ms=fwd_ms, graph_ms=fwd_t["graph_ms"], plain_ms=plain_fwd_ms,
               bound_ms=fwd_bound, bound_by=fwd_by, bound_ms_all_pairs=fwd_all, **cmp)
    bwd = dict(common, ms=bwd_ms, graph_ms=bwd_t["graph_ms"], plain_ms=plain_bwd_ms,
               bound_ms=bwd_bound, bound_by=bwd_by,
               bound_ms_all_pairs=bwd_all, max_abs_err=err_b, max_abs_ref=ref_max,
               loose_share=loose_b)
    say(f"kernel raster_fwd {tag} 512^2 F={common['faces']} P={geom.shape[1]} (longest list "
        f"{common['longest_list']}, {plan['chunks']} chunks of {R.RASTER_CHUNK}) against the "
        f"plain version (every pair): slots differ on {cmp['slot_mismatch_pixels']} pixels, w by "
        f"{cmp['w_err']:.3e} where they agree, vis by {cmp['vis_err']:.3e} (beyond 1e-6 on "
        f"{cmp['vis_pixels_beyond_1e-6']} pixels); same bits in two calls; kernel {fwd_ms:.4f} ms "
        f"(graph replay {fwd_t['graph_ms']:.4f}) plain {plain_fwd_ms:.3f} ms; bound "
        f"{fwd_bound:.4f} ms for {near:.0f} pairs within reach ({fwd_all:.4f} ms for all "
        f"{pairs:.0f} pairs)")
    say(f"kernel raster_bwd {tag} 512^2: err {err_b:.3e} (max|ref| {ref_max:.3e}, {loose_b:.2e} "
        f"of the entries beyond 1e-4 of it); same bits in two calls; kernel {bwd_ms:.4f} ms "
        f"(graph replay {bwd_t['graph_ms']:.4f}) plain {plain_bwd_ms:.3f} ms; bound "
        f"{bwd_bound:.4f} ms within reach ({bwd_all:.4f} ms all pairs)")
    return fwd, bwd, plan, got


def _check_chunk_plan(R, tag, tile_start, n_slots) -> dict:
    """The chunk plan kernel (ops/rasterizer.raster_chunk_plan) against its
    plain version, exactly, right after a call on other inputs."""
    from followmyhold_tpu_torch.tools.time_raster_kernels import time_call

    other = R.raster_chunk_plan(tile_start * 3, 3 * n_slots)
    del other
    got, bound = R.raster_chunk_plan(tile_start, n_slots)
    want, want_bound = R.raster_chunk_plan_plain(tile_start, n_slots)
    if not (torch.equal(got, want) and bound == want_bound):
        fail(f"raster chunk plan {tag}: differs from its plain version")
    t = time_call(lambda: R.raster_chunk_plan(tile_start, n_slots))
    plain = time_call(lambda: R.raster_chunk_plan_plain(tile_start, n_slots))
    T = tile_start.numel() - 1
    t_bytes = (2 * T + 2) * 4.0 / _HBM_BYTES * 1e3
    chunks = int(got[-1].item())
    say(f"kernel raster_chunk_plan {tag} T={T}: {chunks} chunks (grid bound {bound}), equal to "
        f"the plain version; kernel {t['eager_ms']:.4f} ms (graph replay {t['graph_ms']:.4f}), "
        f"plain {plain['eager_ms']:.4f} ms (graph replay {plain['graph_ms']:.4f})")
    return dict(tiles=T, chunks=chunks, grid_bound=bound, ms=t["eager_ms"],
                graph_ms=t["graph_ms"], plain_ms=plain["eager_ms"],
                plain_graph_ms=plain["graph_ms"], bound_ms=t_bytes, bound_by="bytes",
                max_abs_err=0.0)


def _compare_forward(tag, got, ref) -> dict:
    w1, w2, slot, vis = got
    rw1, rw2, rslot, rvis = ref
    same = slot == rslot
    mismatch = 1.0 - same.float().mean().item()
    if mismatch > 1e-3:
        fail(f"raster forward {tag}: winner slots differ on {mismatch:.2%} of the pixels")
    err_w = max((w1 - rw1)[same].abs().max().item(), (w2 - rw2)[same].abs().max().item())
    dvis = (vis - rvis).abs()
    err_v = dvis.max().item()
    if not (err_w <= 1e-5 and err_v <= 1e-4):
        fail(f"raster forward {tag}: w differs by {err_w}, vis by {err_v}")
    return {"max_abs_err": max(err_w, err_v), "slot_mismatch": mismatch,
            "slot_mismatch_pixels": int((~same).sum().item()), "w_err": err_w, "vis_err": err_v,
            "vis_pixels_beyond_1e-6": int((dvis > 1e-6).sum().item())}


def check_scatter(dev, R, packed, slot, sphere) -> dict:
    """The deterministic row scatter-add (csrc/scatter_rows.cu behind
    ops/indexing.scatter_rows_add), the backward of every take_rows, held
    against a float64 index_add_ on the same inputs at three shapes: the
    render's per-pixel gather (the face rows of 262,144 pixels, 9 floats each),
    the most launched (a pixel without a winner gathers its tile's first face,
    as rasterize does; also timed with those pixels spread over the rows by
    pixel index instead), and the corner gather of
    the marching-tets sphere padded to the path's 65,536-face capacity (3 floats
    a corner into 32,768 vertex rows; every padded face is (0, 0, 0), so vertex
    0 holds a run of some 10^4).
    Tolerance: 1e-5 of each output row's sum of magnitudes (the kernel's
    64-bit fixed-point sum, rounded once to f32, against f64; float atomics
    meet it too). It must give the same
    bits in two calls, write every row (the checked call follows a call on
    other inputs whose freed output the allocator hands to it) and not sync the
    host (sync debug mode, and a CUDA graph captures it). The plain version,
    index_add_ with float atomics, is also the library call timed beside it."""
    from followmyhold_tpu_torch.ops import indexing as I
    from followmyhold_tpu_torch.tools.time_raster_kernels import time_call

    n_faces = packed.tri.shape[0]
    pos = packed.tile_start[:-1].long()[:, None, None] + slot.clamp(min=0).long()
    fid = packed.face_list[pos.clamp(max=packed.face_list.numel() - 1)].reshape(-1)
    spread = torch.where(slot.reshape(-1) >= 0, fid,
                         torch.arange(fid.numel(), device=dev) % n_faces)
    shapes = [("render_gather", n_faces, fid, 9),
              ("render_gather_spread", n_faces, spread, 9),
              ("padded_mesh_corners", sphere.verts.shape[0], sphere.faces.reshape(-1), 3)]
    gen = torch.Generator(device=dev).manual_seed(11)
    per_shape = []
    for label, n_rows, index, cols in shapes:
        src = torch.randn((index.numel(), cols), generator=gen, device=dev)
        other = I.scatter_rows_add_forward(n_rows, index.flip(0), -src)
        del other
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = I.scatter_rows_add_forward(n_rows, index, src)
            again = I.scatter_rows_add_forward(n_rows, index, src)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"scatter_rows_add {label}: two calls on the same inputs differ")
        want = I.scatter_rows_add_plain(n_rows, index, src.double())
        scale = I.scatter_rows_add_plain(n_rows, index, src.double().abs())
        excess = ((got.double() - want).abs() - 1e-5 * scale).max().item()
        err = (got.double() - want).abs().max().item()
        if not excess <= 0.0:
            fail(f"scatter_rows_add {label}: differs from the float64 sum beyond 1e-5 of the "
                 f"row sums (max |diff| {err})")
        t = time_call(lambda: I.scatter_rows_add_forward(n_rows, index, src))
        lib = time_call(lambda: I.scatter_rows_add_plain(n_rows, index, src))
        longest = int(torch.bincount(index, minlength=n_rows).max().item())
        nbytes = index.numel() * (8.0 + 4.0 * cols) + n_rows * 4.0 * cols
        t_bytes, t_ops = nbytes / _HBM_BYTES * 1e3, index.numel() * cols / _F32_FLOPS * 1e3
        per_shape.append(dict(shape=label, rows=index.numel(), n_rows=n_rows, cols=cols,
                              longest_run=longest, max_abs_err=err, ms=t["eager_ms"],
                              graph_ms=t["graph_ms"], plain_ms=lib["eager_ms"],
                              library_ms=lib["eager_ms"], library_graph_ms=lib["graph_ms"],
                              bound_ms=max(t_bytes, t_ops),
                              bound_by="bytes" if t_bytes >= t_ops else "operations"))
        say(f"kernel scatter_rows_add {label} {index.numel()} rows -> {n_rows} x {cols} (longest "
            f"run {longest}): max |diff| to float64 {err:.3e}; same bits in two calls, no host "
            f"sync; kernel {t['eager_ms']:.4f} ms (graph replay {t['graph_ms']:.4f}), atomic "
            f"index_add_ {lib['eager_ms']:.4f} ms (graph replay {lib['graph_ms']:.4f}); bound "
            f"{max(t_bytes, t_ops):.4f} ms")
    head = per_shape[0]
    return dict(name="scatter_rows_add", route="cuda", graph_ms=head["graph_ms"],
                source="followmyhold_tpu_torch/csrc/scatter_rows.cu",
                replaces="followmyhold_tpu/ops/rasterizer.py:601",
                replaces_note="no Pallas kernel: the gradient of the reference's gathers "
                              "(here the per-pixel face rows) is XLA's scatter-add",
                max_abs_err=max(x["max_abs_err"] for x in per_shape), ms=head["ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"], shapes=per_shape)


def check_rasterizer(dev) -> list:
    from followmyhold_tpu_torch.ops import rasterizer as R
    from followmyhold_tpu_torch.ops.surface import PaddedMesh, marching_tets, vertex_normals
    from followmyhold_tpu_torch.ops.grid import generate_dense_grid_points
    from followmyhold_tpu_torch.tools._scene import hand_scene

    gen = torch.Generator(device=dev).manual_seed(7)
    # --- the hand mesh at 512^2: forward and backward, tile level ---------- #
    mano, verts, camera, _ = hand_scene(dev, 512)
    faces = mano.faces
    packed = _tile_inputs(camera, verts, faces, 2048)
    fwd_h, bwd_h, plan_h, got_h = _check_raster_shape(R, "hand", packed, gen)

    # --- the hand mesh through rasterize(): gradients to the vertices ------ #
    normals = vertex_normals(PaddedMesh(verts, faces, torch.ones(verts.shape[0], device=dev),
                                        torch.ones(faces.shape[0], device=dev)))
    fmask = torch.ones(faces.shape[0], device=dev)
    tgt_a = torch.zeros((512, 512), device=dev)
    tgt_a[160:320, 160:320] = 1.0

    def render_grads(force_plain):
        v = verts.clone().requires_grad_(True)
        n = normals.clone().requires_grad_(True)
        out = R.rasterize(camera, v, faces, n, fmask, faces_per_tile=2048,
                          force_plain=force_plain, device=dev)
        loss = (((out.alpha - tgt_a) ** 2).sum() + ((out.normal - 0.5) ** 2).sum()
                + torch.where(out.face_id >= 0, out.zbuf, torch.zeros_like(out.zbuf)).sum())
        gv, gn = torch.autograd.grad(loss, (v, n))
        return out, gv, gn

    out_k, gv_k, gn_k = render_grads(False)
    out_k2, gv_k2, gn_k2 = render_grads(False)
    if not (torch.equal(gv_k, gv_k2) and torch.equal(gn_k, gn_k2)):
        fail("rasterize(): two calls give different vertex or normal gradients")
    out_p, gv_p, gn_p = render_grads(True)
    id_mismatch = (out_k.face_id != out_p.face_id).float().mean().item()
    err_gv = (gv_k - gv_p).abs().max().item()
    err_gn = (gn_k - gn_p).abs().max().item()
    tol_gv = 2e-2 * gv_p.abs().max().item() + 1e-6
    tol_gn = 2e-2 * gn_p.abs().max().item() + 1e-6
    if id_mismatch > 1e-3 or not (err_gv <= tol_gv and err_gn <= tol_gn):
        fail(f"rasterize() kernels vs plain: ids differ on {id_mismatch:.2%}, vertex grads by "
             f"{err_gv} (tol {tol_gv}), normal grads by {err_gn} (tol {tol_gn})")
    covered = (out_k.face_id >= 0).float().mean().item()
    say(f"kernel raster fwd+bwd through rasterize(): ids differ on {id_mismatch:.2e}, "
        f"d/dverts err {err_gv:.3e} (max {gv_p.abs().max().item():.3e}), d/dnormals err "
        f"{err_gn:.3e}, same bits in two calls, coverage {covered:.3f}")

    # --- a ~60k-face object mesh at 512^2: forward and backward ------------ #
    xyz, _, _ = generate_dense_grid_points([-1.1] * 3, [1.1] * 3, 64, device=dev)
    sphere = marching_tets(xyz.norm(dim=-1) - 0.8, [-1.1] * 3, [1.1] * 3, 64)
    nf = sphere.num_faces
    obj_verts = sphere.verts * 0.25 + torch.tensor([0.0, 0.0, -0.8], device=dev)
    packed_o = _tile_inputs(camera, obj_verts, sphere.faces[:nf], 24576)
    fwd_o, bwd_o, plan_o, _ = _check_raster_shape(R, "object", packed_o, gen)
    bin_ms = cuda_ms(lambda: _tile_inputs(camera, obj_verts, sphere.faces[:nf], 24576), 1, 5)
    fwd_o["bin_and_pack_ms"] = bin_ms
    say(f"raster object 512^2: projecting, binning and packing it (torch ops) {bin_ms:.3f} ms")
    scatter = check_scatter(dev, R, packed, got_h[2], sphere)
    del packed_o

    # --- the MoGe target mesh of build_targets: a 384x512 image grid ------- #
    from followmyhold_tpu_torch.tools._scene import moge_grid_mesh

    mv, mf = moge_grid_mesh(384, 512, 512, camera.fov_deg)
    moge_v = torch.from_numpy(mv).to(dev)
    moge_f = torch.from_numpy(mf).to(dev).long()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    packed_m = _tile_inputs(camera, moge_v, moge_f, 4096)
    torch.cuda.synchronize()
    bin_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    fwd_m, bwd_m, _, _ = _check_raster_shape(R, "moge", packed_m, gen, plain_iters=1)
    bin_ms_m = cuda_ms(lambda: _tile_inputs(camera, moge_v, moge_f, 4096), 1, 3)
    fwd_m.update(bin_and_pack_ms=bin_ms_m, bin_and_pack_transient_gib=bin_gib,
                 verts=int(mv.shape[0]))
    say(f"raster moge 512^2 ({mv.shape[0]} verts, {mf.shape[0]} faces, the densest tile "
        f"{packed_m.bin_max} of 4096): projecting, binning and packing it (torch ops) "
        f"{bin_ms_m:.3f} ms, {bin_gib:.2f} GiB transient")
    del packed_m

    def entry(name, src, line, hand, obj, **extra):
        return dict(name=name, route="cuda", source=f"followmyhold_tpu_torch/csrc/{src}",
                    replaces=f"followmyhold_tpu/ops/rasterizer.py:{line}",
                    max_abs_err=max(hand["max_abs_err"], obj["max_abs_err"],
                                    extra.get("moge_mesh", {}).get("max_abs_err", 0.0)),
                    ms=hand["ms"],
                    graph_ms=hand["graph_ms"], plain_ms=hand["plain_ms"],
                    bound_ms=hand["bound_ms"], bound_by=hand["bound_by"], library_ms=None,
                    chunk=R.RASTER_CHUNK, hand_mesh=hand, object_mesh=obj, **extra)

    fwd = entry("raster_fwd", "raster_fwd.cu", 506, fwd_h, fwd_o, moge_mesh=fwd_m,
                pixel_face_pairs=fwd_h["pixel_face_pairs"],
                pairs_after_cull=fwd_h["pairs_after_cull"],
                bound_ms_all_pairs=fwd_h["bound_ms_all_pairs"],
                slot_mismatch=max(fwd_h["slot_mismatch"], fwd_o["slot_mismatch"],
                                  fwd_m["slot_mismatch"]))
    bwd = entry("raster_bwd", "raster_bwd.cu", 530, bwd_h, bwd_o, moge_mesh=bwd_m,
                pixel_face_pairs=bwd_h["pixel_face_pairs"],
                pairs_after_cull=bwd_h["pairs_after_cull"],
                bound_ms_all_pairs=bwd_h["bound_ms_all_pairs"], vertex_grad_err=err_gv)
    plan = entry("raster_chunk_plan", "raster_fwd.cu", 506, plan_h, plan_o,
                 replaces_note="no Pallas kernel of its own: the TPU kernel's grid (T, K // C) "
                               "walks a tile's chunks in one program; this plan maps a chunk "
                               "to its tile for one block a chunk")
    return [plan, fwd, bwd, scatter]


# --------------------------------------------------------------------------- #
# main path
# --------------------------------------------------------------------------- #

def _noise_moved(sampler, result, cond_cat, n_steps) -> float:
    """How far the joint phase moved the last noise prediction: the latents
    before the last scheduler step are recovered from the result, the DiT's
    CFG prediction there is taken again, and the optimized prediction is held
    against it."""
    from followmyhold_tpu_torch.diffusion.pipeline import cfg_noise_pred

    sched = sampler._schedule(n_steps)
    i = n_steps - 1
    dsigma = float(np.float32(sched.sigmas[i + 1]) - np.float32(sched.sigmas[i]))
    before = result.latents - dsigma * result.noise_pred
    g = sampler.config.obj_guidance_scale * (1 - i / n_steps)
    with torch.no_grad():
        plain = cfg_noise_pred(sampler.dit, cond_cat, before,
                               sched.timesteps[i] / sched.num_train_timesteps, g)
    return (result.noise_pred - plain).abs().max().item()


# a reduced OptimizationConfig with every phase: 8 steps, the hand phase at step 3,
# the object phase at step 4 and joint phases at steps 5-7 (all near the end, so
# the intersection count runs too)
_TWO_RUN_CONFIG = dict(num_inference_steps=8, optimization_steps_hand=10,
                       optimization_steps_scale=5, optimization_steps_joint=5)


def check_two_runs(dev, dit, vae, camera, targets, cond, uncond) -> None:
    """Two calls of GuidedSampler.run on the same inputs must give the same
    bits: loss curves, latents, noise prediction and both poses. Every scatter
    of the path sums in a fixed order, so nothing may differ."""
    from followmyhold_tpu_torch.configs.guidance import OptimizationConfig, guidance_mesh_caps
    from followmyhold_tpu_torch.diffusion.guidance import GuidedSampler
    from followmyhold_tpu_torch.models.hunyuan import VAE_FULL

    config = OptimizationConfig(**_TWO_RUN_CONFIG)
    runs, secs = [], []
    for _ in range(2):
        sampler = GuidedSampler(dit=dit, vae=vae, camera=camera, config=config,
                                **guidance_mesh_caps())
        t0 = time.perf_counter()
        runs.append(sampler.run(cond, uncond, targets, (VAE_FULL.num_latents, VAE_FULL.embed_dim),
                                generator=torch.Generator(device=dev).manual_seed(2), device=dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    a, b = runs
    wrong = [tag for tag in a.losses if not torch.equal(a.losses[tag], b.losses[tag])]
    if sorted(a.losses) != sorted(b.losses):
        wrong.append("phases")
    for name, x, y in (("latents", a.latents, b.latents), ("noise_pred", a.noise_pred,
                                                           b.noise_pred)):
        if not torch.equal(x, y):
            wrong.append(name)
    for name, x, y in (("hand", a.hand, b.hand), ("obj", a.obj, b.obj)):
        if not all(torch.equal(p, q) for p, q in zip(x, y)):
            wrong.append(f"{name} pose")
    if wrong:
        fail(f"two guided runs on the same inputs differ in: {', '.join(wrong)}")
    say(f"main: two reduced guided runs ({_TWO_RUN_CONFIG}) give the same bits: "
        f"{len(a.losses)} loss curves, latents, noise prediction, poses; "
        f"{secs[0]:.2f} s and {secs[1]:.2f} s")


# the conditioner's tokens with K1 against the same forward with the plain attention:
# measured 7.8e-3 relative (one H100 80GB HBM3 at 700 W: 40 layers of bf16
# attention, K1's per-call 2.9e-3 compounding); the limit is twice that
_COND_REL_LIMIT = 2.0 ** -6
# the shaped random-weight field (see _shape_field): the share of the box inside the
# object at the calibration latents (5-11 % over the in-loop decodes of steps 8-19,
# about the object mask's size on the image), and the factor on the geo decoder's
# attention output
_INSIDE_SHARE = 0.05
_ATTENTION_SCALE = 0.1
IMAGE_ID = "000001"


def _shape_field(dev, dit, vae, cond_main, uncond_main) -> dict:
    """Give the random-weight ShapeVAE a field with an object-sized surface.

    Raw random weights make the geo query's high Fourier frequencies a noise
    field: its surface crosses almost every cell, and the 384^3 export would
    emit ~10^8 faces, which no trained model produces. So the query embedding
    keeps only its lowest frequency (x, sin x, cos x per axis; the other
    columns of query_in are zeroed); the attention's output projection is
    scaled by _ATTENTION_SCALE, so that the latents move the surface without
    moving the field's level past it (at full scale the level moved by about
    twice the field's 5-95 % spread between random and denoised latents, and
    the object phase saw no surface); and the logit bias is set so that
    _INSIDE_SHARE of a 33^3 grid over the box is inside at the latents of an
    unguided 20-step run from the stage's own initial noise and condition.
    All of it is seeded, so every run of the script gets the same weights."""
    from followmyhold_tpu_torch.diffusion.pipeline import denoise_latents
    from followmyhold_tpu_torch.utils.prng import SEED_GUIDANCE, stage_generator

    c = vae.cfg
    per = 2 * c.fourier_freqs + 1
    keep = torch.zeros(3 * per, dtype=torch.bool, device=dev)
    keep[[a * per + j for a in range(3) for j in (0, 1, 1 + c.fourier_freqs)]] = True
    shape = (1, c.num_latents, c.embed_dim)
    noise = torch.randn(shape, generator=stage_generator(SEED_GUIDANCE, "guidance", IMAGE_ID, dev),
                        device=dev)
    lat = denoise_latents(dit, cond_main, uncond_main, shape[1:], num_inference_steps=20,
                          guidance_scale=5.0, initial_noise=noise, device=dev)
    with torch.no_grad():
        vae.geo.query_in.weight[:, ~keep] = 0.0
        vae.geo.proj.weight.mul_(_ATTENTION_SCALE)
        vae.geo.proj.bias.mul_(_ATTENTION_SCALE)
    g = _box_logits(dev, vae, lat)
    level = torch.quantile(g, 1.0 - _INSIDE_SHARE).item()
    with torch.no_grad():
        vae.geo.logit.bias -= level
    return dict(logit_shift=-level, spread=(g.max() - g.min()).item())


def _box_logits(dev, vae, lat) -> torch.Tensor:
    """The field's logits on a 33^3 grid over the box, for each latents of the
    batch lat: [B, 33^3] float32."""
    from followmyhold_tpu_torch.models.hunyuan import vae_query_logits
    from followmyhold_tpu_torch.ops.grid import generate_dense_grid_points

    xyz, _, _ = generate_dense_grid_points([-1.1] * 3, [1.1] * 3, 32, device=dev)
    with torch.no_grad():
        return torch.stack([vae_query_logits(vae, lat[b:b + 1], xyz[None])[0].float()
                            for b in range(lat.shape[0])])


def _timed(fn, record: dict, key: str):
    """fn, with the synchronized wall time of each call appended to record[key]."""
    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        record.setdefault(key, []).append(time.perf_counter() - t0)
        return out
    return wrapped


HOI_IDS = (IMAGE_ID, "000002")


def _count_syncs(fn) -> int:
    """How often fn synchronises the host with the device (torch's sync debug
    mode warns once per synchronising call)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message).lower() for w in caught)


def _stage5_level(dev, models, image_dir: str) -> dict:
    """The logit level that puts _INSIDE_SHARE of the box inside at the
    latents stage 5 reaches for HOI_IDS (30 CFG steps at 7.5 from the stage's
    own noise and conditions: another field level than the guidance stage's
    20 steps at 5.0, which _shape_field calibrates, and the export of the
    guidance-shaped field held no surface there). The stage runs with the
    logit bias moved by it; every other weight is the guidance stage's."""
    from PIL import Image

    from followmyhold_tpu_torch.diffusion.pipeline import denoise_latents
    from followmyhold_tpu_torch.geometry.hunyuan import encode_condition, white_to_alpha
    from followmyhold_tpu_torch.utils.prng import SEED_HUNYUAN, stage_generator

    dit, vae, cond = models
    shape = (1, vae.cfg.num_latents, vae.cfg.embed_dim)
    conds, unconds, noise = [], [], []
    for k, image_id in enumerate(HOI_IDS):
        rgb = np.asarray(Image.open(os.path.join(image_dir, f"{image_id}_cropped_hoi_{k % 2}.png"))
                         .convert("RGB"))
        c, u = encode_condition(cond, white_to_alpha(rgb), device=dev)
        conds.append(c[0])
        unconds.append(u[0])
        noise.append(torch.randn(shape, generator=stage_generator(SEED_HUNYUAN, "hunyuan",
                                                                  image_id, dev), device=dev))
    lat = denoise_latents(dit, torch.stack(conds), torch.stack(unconds), shape[1:],
                          num_inference_steps=30, guidance_scale=7.5,
                          initial_noise=torch.cat(noise), device=dev)
    g = _box_logits(dev, vae, lat)
    level = torch.quantile(g.flatten(), 1.0 - _INSIDE_SHARE).item()
    shares = (g > level).float().mean(dim=1).tolist()
    say(f"hoi: stage 5's field level {level:.4f} (the guidance-shaped field's logits over the "
        f"box span {g.min().item():.4f} to {g.max().item():.4f}); inside shares then "
        f"{[round(x, 4) for x in shares]}")
    if min(shares) <= 0.0:
        fail(f"stage 5's field has no surface for one of {HOI_IDS}: inside shares {shares}")
    return dict(level=level, inside_shares=shares)


# stage 3's full-width transformer forward with K1 against the same forward with the
# plain attention: measured 1.25e-2 relative (one H100 80GB HBM3 at 700 W: 57 blocks of
# bf16 attention, K1's per-call 2.9e-3 compounding through the residual stream); the
# limit is twice that
_FLUX_REL_LIMIT = 2.5e-2
_INPAINT_PROMPT = "Remove hands but keep the object."


def run_inpaint_stage(dev) -> dict:
    """Stage 3 as a user runs it: preprocess/inpaint.run on the two HOI crops of
    HOI_IDS with their hand masks (write_stage_inputs, as stages 4-8 get them),
    with the FLUX.1-Kontext inpainter at full width and depth (build_inpainter:
    FLUX.1-Kontext-dev, the FLUX VAE, CLIP-L and T5-XXL; bf16, seeded random
    weights, built on the card) and synthetic tokenizer vocabularies
    (tools._scene.flux_tokenizer_assets), so the prompt takes the checkpoint's
    path: [1,77] CLIP and [1,512] T5 ids, K1 at [1,24,2560,128]. The launch counts
    are set to 0 just before the run and read just after. Checks each
    {id}_inpainted_{rid}.png (512x512x3 uint8, not its input), the final latents
    finite, 57 x 28 K1 launches an image and no other kernel, two 2-step
    kontext_edit calls with the same bits, and one full-width transformer forward
    with K1 against the same forward with the plain attention. Prints s per image
    by part (the card's parts on CUDA events, no host synchronisation added
    inside the stage), the median step and peak memory. The models are freed
    before the stages that follow."""
    import gc
    import tempfile

    from PIL import Image

    from followmyhold_tpu_torch.models import flux as F
    from followmyhold_tpu_torch.ops import _kernels
    from followmyhold_tpu_torch.ops.attention import attention_plain
    from followmyhold_tpu_torch.preprocess import inpaint as stage3
    from followmyhold_tpu_torch.tools import profile_inpaint as P
    from followmyhold_tpu_torch.tools._scene import flux_tokenizer_assets, write_stage_inputs

    with tempfile.TemporaryDirectory(prefix="fmh_stage3_") as root, flux_tokenizer_assets():
        d = write_stage_inputs(root, image_id=IMAGE_ID, size=512, moge_grid=(8, 8),
                               hoi_ids=HOI_IDS)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        inpainter = stage3.build_inpainter(seed=0, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_params = {name: round(sum(p.numel() for p in getattr(inpainter, name).parameters())
                                / 1e9, 4) for name in ("transformer", "vae", "clip", "t5")}
        say(f"inpaint: built FLUX.1-Kontext-dev + FLUX VAE + CLIP-L + T5-XXL at full width "
            f"({n_params}, billions of parameters; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card) in {build_s:.1f} s")

        out_dir = os.path.join(root, "inpainted")
        record, finite = {}, []
        unpack = F.unpack_latents

        def checked_unpack(tokens, h, w):      # the final latents of each image
            finite.append(torch.isfinite(tokens).all())
            return unpack(tokens, h, w)

        F.unpack_latents = checked_unpack
        try:
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with P.timed_parts(record):
                stage3.run(out_dir, d["cropped_hoi_dir"], mask_dir=d["mask_dir"],
                           models=inpainter, device=dev)
            torch.cuda.synchronize()
            stage_s = time.perf_counter() - t0
            launches = _kernels.launch_counts()
        finally:
            F.unpack_latents = unpack
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        n = len(HOI_IDS)
        parts = P.summarize_parts(record, n)
        rest = stage_s / n - sum(parts[p] for p in P.PARTS)
        n_blocks = F.FLUX_DEV.num_layers + F.FLUX_DEV.num_single_layers
        n_steps = parts["n_steps"]
        say(f"inpaint: stage 3 (FLUX.1-Kontext, {n} images) {stage_s:.3f} s, "
            f"{stage_s / n:.3f} s per image: tokenizing {parts['tokenize']:.4f}, T5 and CLIP "
            f"{parts['text']:.4f}, VAE encode {parts['vae_encode']:.4f}, {n_steps} steps "
            f"{parts['steps']:.4f} (median step {parts['step_median']:.4f}), VAE decode "
            f"{parts['vae_decode']:.4f}, PNG {parts['png']:.4f}, reading, host copies and the "
            f"rest {rest:.4f} s per image (the steps of each image: "
            f"{', '.join(f'{x:.3f}' for x in parts['steps_per_image'])} s; VAE encodes "
            f"{', '.join(f'{x:.4f}' for x in parts['calls']['vae_encode'])} s, the first pays "
            f"one-time set-up); peak {peak_gib:.2f} GiB; launches {launches}")

        want = {k: 0 for k in launches}
        want["flash_attention_fwd"] = n_blocks * n_steps * n
        if n_steps != 28 or launches != want:
            fail(f"stage 3 ran {n_steps} steps an image and launched {launches}, expected 28 "
                 f"steps and {want} ({n_blocks} K1 launches a step)")
        if len(finite) != n or not all(bool(x) for x in finite):
            fail(f"stage 3's final latents are not finite: {[bool(x) for x in finite]}")
        outputs = {}
        for k, image_id in enumerate(HOI_IDS):
            path = os.path.join(out_dir, f"{image_id}_inpainted_{k % 2}.png")
            if not os.path.exists(path):
                fail(f"stage 3 wrote no {os.path.basename(path)}")
            got = np.asarray(Image.open(path))
            crop = np.asarray(Image.open(os.path.join(
                d["cropped_hoi_dir"], f"{image_id}_cropped_hoi_{k % 2}.png")).convert("RGB"))
            if got.shape != (512, 512, 3) or got.dtype != np.uint8 or np.array_equal(got, crop):
                fail(f"stage 3's {os.path.basename(path)} is {got.shape} {got.dtype}, or equal "
                     f"to its input")
            outputs[image_id] = dict(mean=round(float(got.mean()), 2),
                                     black=round(float((got == 0).mean()), 4),
                                     white=round(float((got == 255).mean()), 4))
        say(f"inpaint: both files are 512x512x3 uint8 and differ from their crops: {outputs}")

        # two 2-step edits of image 0 on the same inputs give the same bits
        crop = np.asarray(Image.open(os.path.join(
            d["cropped_hoi_dir"], f"{IMAGE_ID}_cropped_hoi_0.png")).convert("RGB"))
        inputs = P.step_inputs(inpainter, crop, _INPAINT_PROMPT)
        x_in, t5, pooled = inputs[:3]
        image = torch.from_numpy(crop.astype(np.float32))[None].to(dev) / 255.0
        with torch.no_grad():
            edits = [F.kontext_edit(inpainter.transformer, inpainter.vae, t5, pooled, image,
                                    num_steps=2, initial_noise=x_in[:, :x_in.shape[1] // 2])
                     for _ in range(2)]
        if not torch.equal(*edits):
            fail("two 2-step kontext_edit calls on the same inputs differ")

        # the full-width forward with K1 against the same forward with the plain attention
        with torch.no_grad():
            with_k1 = inpainter.transformer(*inputs)
            with_kernel = F.multi_head_attention
            F.multi_head_attention = lambda q, k, v, device=None: attention_plain(
                q, k, v, scale=1.0 / math.sqrt(q.shape[-1]))
            try:
                plain = inpainter.transformer(*inputs)
            finally:
                F.multi_head_attention = with_kernel
        rel = _rel_err(with_k1, plain)
        if not (math.isfinite(rel) and rel <= _FLUX_REL_LIMIT):
            fail(f"the transformer with K1 differs from the plain attention's by {rel} relative "
                 f"(limit {_FLUX_REL_LIMIT})")
        say(f"inpaint: two 2-step kontext_edit calls give the same bits; the transformer "
            f"{list(with_k1.shape)} with K1 against the plain attention: relative {rel:.3e} "
            f"(limit {_FLUX_REL_LIMIT:.2e})")
        del inpainter, inputs, x_in, t5, pooled, image, edits, with_k1, plain
        gc.collect()
        torch.cuda.empty_cache()
    return dict(launches=launches, seconds=stage_s, parts=parts, rel=rel, peak_gib=peak_gib)


def profile_flux_step(dev) -> dict:
    """One full-width FLUX.1-Kontext step under torch.profiler, on a random 512^2
    crop with the synthetic vocabularies, in a freshly built inpainter -> its
    numbers: the device-busy share, K1's and the GEMM library's device ms. A
    profiler session leaves the process's launches slower (PERF.md §6, PR 10),
    so this runs after the last timed stage."""
    from followmyhold_tpu_torch.preprocess.inpaint import build_inpainter
    from followmyhold_tpu_torch.tools import profile_inpaint as P
    from followmyhold_tpu_torch.tools._scene import flux_tokenizer_assets

    torch.cuda.empty_cache()
    inpainter = build_inpainter(seed=0, device=dev)
    crop = np.random.default_rng(0).integers(0, 256, (512, 512, 3), dtype=np.uint8)
    with flux_tokenizer_assets():
        inputs = P.step_inputs(inpainter, crop, _INPAINT_PROMPT)
    with torch.no_grad():
        prof = P.profile_call(lambda: inpainter.transformer(*inputs))
    say(prof.pop("table"))
    say(f"inpaint: one step under torch.profiler: {prof['wall_ms']:.2f} ms wall, device busy "
        f"{prof['device_ms']:.2f} ms = {prof['busy']:.1%}; K1 {prof['k1_ms']:.2f} ms "
        f"({prof['k1_ms'] / prof['device_ms']:.1%} of device time), GEMM library "
        f"{prof['gemm_ms']:.2f} ms ({prof['gemm_ms'] / prof['device_ms']:.1%}); "
        f"{prof['launches']} launches; T5 states {list(inputs[1].shape)}")
    if not prof["k1_ms"] > 0.0 or inputs[1].shape[1] != 512:
        fail(f"the profiled FLUX step ran no K1 or not the 512 T5 tokens: {prof}")
    return prof


# MoGe's random-weight head outputs are blended into a scene (see _shape_moge): the
# share of the raw points (scaled to at most 1) and of the raw mask kept
_MOGE_NOISE = 1e-3


def _shape_moge(model, dev):
    """Give the random-weight MoGe a point map that is a scene. Random
    weights predict points with no perspective in them: the focal fit's cost
    is flat (its minimum, and so the field of view, is rounding noise, and
    the closed-form focal may be negative), and the depth varies from pixel
    to pixel by more than the depth-edge limit, so that no face survives. A
    forward hook on the model blends tools._scene.moge_scene into the head
    outputs: an object in front of a tilted background at 60 degrees, its z
    shifted by 1.5, a strip of invalid pixels along the top, plus _MOGE_NOISE
    of the raw points (scaled to at most 1) and of the raw mask; normals and
    the metric scale stay as predicted. Everything before the heads' output,
    the encoder's K1 launches included, runs as it is. -> the hook's handle."""
    from followmyhold_tpu_torch.tools._scene import moge_scene

    scenes = {}

    def hook(module, args, out):
        H, W = args[0].shape[1:3]
        if (H, W) not in scenes:
            pts, mask = moge_scene(H, W)
            scenes[(H, W)] = (torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev))
        pts, mask = scenes[(H, W)]
        raw = out["points"]
        return dict(out, points=pts[None] + _MOGE_NOISE * raw / raw.abs().amax().clamp(min=1.0),
                    mask=mask[None] + _MOGE_NOISE * (out["mask"] - 0.5))

    return model.register_forward_hook(hook)


def run_moge_stage(dev, d: dict, out_dir: str) -> dict:
    """Stage 4 as a user runs it: geometry/moge.run on the HOI crops without
    background (write_stage_inputs' hoi_ids) with MoGe at full width (DINOv2-L,
    24 x 1024, bf16; the published neck and heads; resolution level 9: a 60x60
    grid, K1 at [1,16,3601,64]) on seeded random weights, its head outputs
    shaped into a scene (_shape_moge). The launch counts are set to 0 just
    before and read just after. It prints s per image split into resize and
    forward, focal and shift, the mesh and the file writes, and the host
    synchronisations, and checks every file."""
    import json

    from PIL import Image

    from followmyhold_tpu_torch.configs.profiles import moge_config
    from followmyhold_tpu_torch.geometry import moge as stage4
    from followmyhold_tpu_torch.models import moge as M
    from followmyhold_tpu_torch.ops import _kernels
    from followmyhold_tpu_torch.utils.mesh_io import load_mesh

    t0 = time.perf_counter()
    cfg = moge_config()
    model = stage4._build_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters()) / 1e9
    say(f"moge: built MoGe at full width (DINOv2-L + neck + heads, {n_params:.3f} billion "
        f"parameters, bf16) in {time.perf_counter() - t0:.1f} s")
    handle = _shape_moge(model, dev)
    calls = {}
    patched = [(M.MoGe, "forward", "resize_and_forward"),
               (M, "recover_focal_shift", "focal_shift"),
               (stage4, "depth_edge", "mesh"), (stage4, "image_mesh", "mesh")]
    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in patched]
    try:
        for (owner, name, key), (_, _, fn) in zip(patched, originals):
            setattr(owner, name, _timed(fn, calls, key))
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stage4.run(d["cropped_hoi_wo_bckg_dir"], out_dir, models=model, device=dev)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        launches = _kernels.launch_counts()
        for owner, name, fn in originals:
            setattr(owner, name, fn)
        # the host synchronisations of one image's forward, focal fit and outputs
        crop = np.asarray(Image.open(os.path.join(
            d["cropped_hoi_wo_bckg_dir"], f"{HOI_IDS[0]}_cropped_hoi_0.png")).convert("RGB"))
        image = torch.from_numpy(crop.astype(np.float32) / 255.0)[None].to(dev)
        syncs = _count_syncs(lambda: M.moge_infer(model, image))
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
        handle.remove()
    del model
    torch.cuda.empty_cache()

    n = len(HOI_IDS)
    secs = {key: sum(calls.get(key, [0.0])) for _, _, key in patched}
    writes = stage_s - sum(secs.values())
    say(f"moge: stage 4 (MoGe, {n} images) {stage_s:.3f} s, {stage_s / n:.3f} s per image: "
        f"resize and forward {secs['resize_and_forward'] / n:.4f}, focal and shift "
        f"{secs['focal_shift'] / n:.4f}, depth edges and image_mesh {secs['mesh'] / n:.4f}, "
        f"reading, host copies and file writes {writes / n:.4f} s per image (each forward: "
        f"{', '.join(f'{x:.4f}' for x in calls['resize_and_forward'])} s; the first pays "
        f"one-time set-up); moge_infer syncs the host {syncs} times; launches {launches}")

    want_k1 = cfg.encoder.depth * n
    if launches["flash_attention_fwd"] != want_k1:
        fail(f"stage 4 launched K1 {launches['flash_attention_fwd']} times, expected {want_k1} "
             f"(24 per image)")
    files = ("depth.npy", "points.npy", "mask.png", "normal.png", "fov.json", "mesh.ply",
             "pointcloud.ply")
    per_image = {}
    for image_id in HOI_IDS:
        sub = os.path.join(out_dir, f"{image_id}_cropped_hoi")
        missing = [f for f in files if not os.path.exists(os.path.join(sub, f))]
        if missing:
            fail(f"stage 4: {image_id} lacks {missing}")
        depth = np.load(os.path.join(sub, "depth.npy"))
        points = np.load(os.path.join(sub, "points.npy"))
        mask = np.asarray(Image.open(os.path.join(sub, "mask.png"))) > 0
        with open(os.path.join(sub, "fov.json"), encoding="utf-8") as f:
            fov = json.load(f)
        mesh = load_mesh(os.path.join(sub, "mesh.ply"))
        cloud = load_mesh(os.path.join(sub, "pointcloud.ply"))
        if not (depth.shape == crop.shape[:2] and points.shape == crop.shape
                and np.isfinite(depth).all() and np.isfinite(points).all()):
            fail(f"stage 4: {image_id}'s depth {depth.shape} or points {points.shape} are not "
                 f"finite maps of the crop's size")
        if not all(0.0 < fov[k] < 180.0 for k in ("fov_x", "fov_y")):
            fail(f"stage 4: {image_id}'s field of view {fov}")
        if not (mesh.num_faces > 0 and np.isfinite(mesh.vertices).all()
                and (mesh.vertices[:, 2] <= 0).all()
                and cloud.num_vertices == mesh.num_vertices):
            fail(f"stage 4: {image_id}'s mesh has {mesh.num_faces} faces, or vertices behind "
                 f"the camera (GL z > 0), or its point cloud differs")
        if not (mask.any() and (depth[mask] > 0).all()):
            fail(f"stage 4: {image_id}'s mask is empty or holds a depth <= 0")
        per_image[image_id] = dict(fov=fov, faces=int(mesh.num_faces),
                                   verts=int(mesh.num_vertices), mask_share=float(mask.mean()),
                                   depth_range=[float(depth[mask].min()),
                                                float(depth[mask].max())])
    say(f"moge: every file written and checked: {per_image}")
    return dict(seconds=stage_s, calls=calls, syncs=syncs, launches=launches,
                per_image=per_image)


def run_hoi_stages(dev, models, d: dict, root: str) -> dict:
    """Stages 4-8 as a user runs them, on the two HOI crops of HOI_IDS
    (write_stage_inputs; image 0 a left hand, image 1 a right one): first
    stage 4 (run_moge_stage, with its own launch counts), then
    geometry/hunyuan.run on both in one batch with the full-width models
    (the DiT at [4, ...] with CFG, K1 at [4,16,4442,128]), each through the
    384^3 export and the post-processing; hand/hamer.run with the full-width
    HaMeR (ViT-H, bf16) and the overlay (K3); alignment/h2m.run against stage
    4's meshes and alignment/mano.run. The kernels' counts are set to 0 just
    before stages 5-8 and read just after. Then the checks, K3 held against
    its plain version on the overlay's render, ICP's host synchronisations
    counted, and guidance/run.build_targets on image 0's files, stage 4's
    mesh and field of view among them (its time and transient memory)."""
    from followmyhold_tpu_torch.alignment import h2m, mano as mano_align, mesh_align
    from followmyhold_tpu_torch.diffusion import pipeline
    from followmyhold_tpu_torch.geometry import hunyuan as hoi
    from followmyhold_tpu_torch.guidance import run as stage
    from followmyhold_tpu_torch.hand import hamer as hand
    from followmyhold_tpu_torch.models.hunyuan import COND_FULL, DIT_FULL
    from followmyhold_tpu_torch.ops import _kernels
    from followmyhold_tpu_torch.ops import rasterizer as R
    from followmyhold_tpu_torch.ops.camera import GuidanceCamera
    from followmyhold_tpu_torch.ops.icp import icp, procrustes, sample_surface
    from followmyhold_tpu_torch.utils.mesh_io import load_mesh

    out = {k: os.path.join(root, "stages", k) for k in (
        "moge_out_dir", "hunyuan_hoi_mesh_dir", "hamer_out_dir", "h2m_rt_dir",
        "aligned_mano_dir")}
    moge = run_moge_stage(dev, d, out["moge_out_dir"])
    t0 = time.perf_counter()
    hamer_model = hand._build_model(hand._default_config(), device=dev)
    torch.cuda.synchronize()
    n_hamer = sum(p.numel() for p in hamer_model.parameters()) / 1e9
    say(f"hoi: built HaMeR at full width (ViT-H + head, {n_hamer:.3f} billion parameters, "
        f"bf16) in {time.perf_counter() - t0:.1f} s")

    level5 = _stage5_level(dev, models, d["cropped_hoi_wo_bckg_dir"])
    vae = models[1]
    bias = vae.geo.logit.bias.detach().clone()

    calls = {}

    patched = [(hoi, "encode_condition", "conditioner"), (hoi, "denoise_latents", "dit_loop"),
               (pipeline, "hierarchical_export_logits", "export_decode"),
               (pipeline, "marching_tets_host", "host_extraction"),
               (hoi, "remove_floaters", "postprocess"),
               (hoi, "remove_degenerate_faces", "postprocess"),
               (hoi, "reduce_faces", "postprocess"), (hand, "generate_patch_image", "crop"),
               (hand, "hamer_forward", "forward"), (hand, "render_overlay", "overlay"),
               (mesh_align, "_sample", "icp_sampling")]
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    icp_orig = mesh_align.icp

    stage_s, counts = {}, {}
    try:
        with torch.no_grad():
            vae.geo.logit.bias -= level5["level"]
        for (mod, name, key), (_, _, fn) in zip(patched, originals):
            setattr(mod, name, _timed(fn, calls, key))
        mesh_align.icp = _timed(icp_orig, calls, "icp")
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        for tag, fn in (
                ("stage5", lambda: hoi.run(d["cropped_hoi_wo_bckg_dir"],
                                           out["hunyuan_hoi_mesh_dir"], models=models,
                                           device=dev)),
                ("stage6", lambda: hand.run(d["cropped_hoi_dir"], out["hamer_out_dir"],
                                            mask_dir=d["mask_dir"], save_overlay=True,
                                            model=hamer_model, device=dev)),
                ("stage7", lambda: h2m.run(out["hunyuan_hoi_mesh_dir"], out["moge_out_dir"],
                                           out["h2m_rt_dir"], device=dev)),
                ("stage8", lambda: mano_align.run(out["hamer_out_dir"],
                                                  out["hunyuan_hoi_mesh_dir"],
                                                  out["aligned_mano_dir"], device=dev))):
            before = _kernels.launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            stage_s[tag] = time.perf_counter() - t
            counts[tag] = {k: v - before[k] for k, v in _kernels.launch_counts().items()}
            if tag == "stage5":
                for image_id in HOI_IDS:
                    mesh = load_mesh(os.path.join(out["hunyuan_hoi_mesh_dir"],
                                                  f"{image_id}_hoi_mesh.ply"))
                    if not (mesh.num_faces > 0 and np.isfinite(mesh.vertices).all()):
                        fail(f"stage 5: {image_id}_hoi_mesh.ply is empty or not finite")
        launches = _kernels.launch_counts()
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
        mesh_align.icp = icp_orig
        with torch.no_grad():
            vae.geo.logit.bias.copy_(bias)
    n = len(HOI_IDS)
    secs = {key: sum(calls.get(key, [0.0])) for _, _, key in patched}
    icp_secs = calls["icp"]

    def each(key):
        return ", ".join(f"{x:.4f}" for x in calls[key])

    say(f"hoi: stage 5 (Hunyuan HOI mesh, {n} images in one batch) {stage_s['stage5']:.2f} s, "
        f"{stage_s['stage5'] / n:.2f} s per image: conditioner {secs['conditioner'] / n:.4f}, "
        f"DiT loop (30 steps at batch {2 * n}) {secs['dit_loop'] / n:.3f}, export decode "
        f"{secs['export_decode'] / n:.3f}, host extraction {secs['host_extraction'] / n:.3f}, "
        f"post-processing {secs['postprocess'] / n:.3f} s per image")
    say(f"hoi: stage 6 (HaMeR) {stage_s['stage6']:.3f} s, {stage_s['stage6'] / n:.3f} s per "
        f"image: crop {secs['crop'] / n:.4f}, forward {secs['forward'] / n:.4f}, overlay "
        f"{secs['overlay'] / n:.4f} s per image (each call: crop {each('crop')}, forward "
        f"{each('forward')}, overlay {each('overlay')} s; the first pays one-time set-up)")
    coarse, fine = icp_secs[0::2], icp_secs[1::2]
    say(f"hoi: stage 7 (Hunyuan -> MoGe ICP) {stage_s['stage7']:.3f} s, stage 8 (MANO -> "
        f"Hunyuan ICP) {stage_s['stage8']:.3f} s; per alignment: coarse phase (50 iterations, "
        f"1k/5k) {', '.join(f'{x:.3f}' for x in coarse)} s, fine phase (100 iterations, "
        f"5k/10k) {', '.join(f'{x:.3f}' for x in fine)} s, surface sampling "
        f"{secs['icp_sampling'] / len(coarse):.3f} s per alignment")
    say(f"hoi: launches per stage {counts}")

    # ---- checks -------------------------------------------------------------- #
    for image_id in HOI_IDS:
        res = np.load(os.path.join(out["hamer_out_dir"], f"{image_id}.npy"),
                      allow_pickle=True).item()
        kps = np.load(os.path.join(out["hamer_out_dir"], f"{image_id}_kps_for_guidance.npy"),
                      allow_pickle=True).item()
        if sorted(res) != sorted(hand._STACK_KEYS) or sorted(kps) != [
                "cam_t", "mano_2d_kps", "mano_3d_kps"]:
            fail(f"stage 6: {image_id}'s arrays have the keys {sorted(res)}, {sorted(kps)}")
        if not all(np.isfinite(np.asarray(v, np.float64)).all()
                   for v in (*res.values(), *kps.values())):
            fail(f"stage 6: {image_id}'s arrays are not finite")
        if not (res["pred_cam_t_full"][0, 2] > 0 and res["right"][0] == float(
                HOI_IDS.index(image_id) % 2 == 1)):
            fail(f"stage 6: {image_id}'s hand is behind the camera or on the wrong side")
        obj = load_mesh(os.path.join(out["hamer_out_dir"], f"{image_id}_hamer.obj"))
        over_path = os.path.join(out["hamer_out_dir"], f"{image_id}_overlay.png")
        if not (obj.num_vertices == 778 and os.path.exists(over_path)):
            fail(f"stage 6: {image_id}_hamer.obj has {obj.num_vertices} vertices or the overlay "
                 f"is missing")
        t_h2m = np.load(os.path.join(out["h2m_rt_dir"], f"{image_id}_hoi_mesh.npy"))
        if not (t_h2m.shape == (4, 4) and np.isfinite(t_h2m).all()
                and np.array_equal(t_h2m[3], [0, 0, 0, 1])):
            fail(f"stage 7: {image_id}_hoi_mesh.npy is not a finite transform: {t_h2m}")
        aligned = load_mesh(os.path.join(out["aligned_mano_dir"],
                                         f"{image_id}_hamer_aligned_mano.ply"))
        if not (aligned.num_vertices == 778 and np.isfinite(aligned.vertices).all()):
            fail(f"stage 8: {image_id}'s aligned MANO has {aligned.num_vertices} vertices or is "
                 f"not finite")
    n_blocks = DIT_FULL.depth_double + DIT_FULL.depth_single
    if counts["stage5"]["flash_attention_fwd"] < n_blocks * 30 + n * COND_FULL.depth:
        fail(f"stage 5 launched K1 {counts['stage5']['flash_attention_fwd']} times, expected at "
             f"least {n_blocks * 30 + n * COND_FULL.depth}")
    if counts["stage6"]["raster_fwd"] < n or counts["stage6"]["raster_chunk_plan"] < n:
        fail(f"stage 6 launched K3 {counts['stage6']['raster_fwd']} times for {n} overlays")

    # K3 against its plain version on image 0's overlay render
    img0 = HOI_IDS[0]
    hand_mask = stage._load_mask(os.path.join(d["mask_dir"], f"{img0}_cropped_hand_mask.png"))
    frame_hw = hand_mask.shape
    cfg = hamer_model.cfg
    res = np.load(os.path.join(out["hamer_out_dir"], f"{img0}.npy"), allow_pickle=True).item()
    faces = np.asarray(load_mesh(os.path.join(out["hamer_out_dir"], f"{img0}_hamer.obj")).faces)
    hands = [{"pred_vertices": res["pred_vertices"][0],
              "pred_cam_t_full": res["pred_cam_t_full"][0]}]
    camera, verts, fcs, _ = hand.overlay_scene(
        hands, faces, frame_hw, cfg.focal_length / cfg.image_size * max(frame_hw), dev)
    packed = _tile_inputs(camera, verts, fcs, hand.overlay_faces_per_tile(fcs.shape[0]))
    fwd_ov, bwd_ov, _, got = _check_raster_shape(R, "overlay", packed,
                                                 torch.Generator(device=dev).manual_seed(13))
    covered = int((got[2] >= 0).sum().item())
    if covered == 0:
        fail("the overlay render covers no pixel")
    say(f"hoi: the overlay of {img0} covers {covered} pixels")

    # ICP's host synchronisations (torch.linalg.svd of the 3x3 covariance)
    target = load_mesh(os.path.join(out["hunyuan_hoi_mesh_dir"], f"{img0}_hoi_mesh.ply"))
    src = torch.from_numpy(sample_surface(target.vertices, target.faces, 5000, 0)).to(dev)
    tgt = torch.from_numpy(sample_surface(target.vertices, target.faces, 10000, 1)).to(dev)
    syncs = {"procrustes": _count_syncs(lambda: procrustes(src, tgt[:5000])),
             "icp_iteration": _count_syncs(lambda: icp(src, tgt, n_iter=1, outliers=0.2)),
             "icp_10_iterations": _count_syncs(lambda: icp(src, tgt, n_iter=10, outliers=0.2))}
    say(f"hoi: host synchronisations: {syncs}")

    # the guidance stage's targets from image 0's files of these stages: stage 4's
    # mesh (a 512x512 grid, above build_targets' caps: truncated as the reference
    # truncates it) at stage 4's field of view
    import json

    moge_dir = os.path.join(out["moge_out_dir"], f"{img0}_cropped_hoi")
    with open(os.path.join(moge_dir, "fov.json"), encoding="utf-8") as f:
        fovx = float(json.load(f)["fov_x"])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    targets = stage.build_targets(
        GuidanceCamera(height=frame_hw[0], width=frame_hw[1], fov_deg=fovx),
        os.path.join(out["aligned_mano_dir"], f"{img0}_hamer_aligned_mano.ply"),
        os.path.join(out["h2m_rt_dir"], f"{img0}_hoi_mesh.npy"),
        os.path.join(moge_dir, "mesh.ply"), hand_mask,
        stage._load_mask(os.path.join(d["mask_dir"], f"{img0}_cropped_obj_mask.png")),
        os.path.join(out["hamer_out_dir"], f"{img0}_kps_for_guidance.npy"),
        np.load(os.path.join(out["hamer_out_dir"], "J_regressor_hamer.npy")), device=dev)
    torch.cuda.synchronize()
    targets_s = time.perf_counter() - t0
    targets_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    if not (targets.mano_verts_moge.shape == (778, 3) and targets.hamer_2d_kps.shape == (21, 2)
            and all(torch.isfinite(x).all() for x in (
                targets.mano_verts_moge, targets.hamer_2d_kps, targets.moge_normal,
                targets.moge_disp, targets.t_h2m))):
        fail("build_targets on the files of stages 4-8 gave wrong shapes or non-finite values")
    if not targets.moge_disp.abs().amax().item() > 0:
        fail("build_targets: stage 4's mesh renders no disparity inside the masks")
    say(f"hoi: build_targets accepts {img0}'s files of stages 4-8 (stage 4's mesh of "
        f"{moge['per_image'][img0]['faces']} faces at {fovx} degrees; MANO in MoGe space centred "
        f"at {targets.mano_verts_moge.mean(0).tolist()}) in {targets_s:.3f} s, "
        f"{targets_gib:.2f} GiB transient")
    return dict(launches=launches, launches_per_stage=counts, seconds=stage_s, calls=calls,
                syncs=syncs, field=level5, moge=moge,
                build_targets=dict(seconds=targets_s, transient_gib=targets_gib),
                raster_overlay=(fwd_ov, bwd_ov))


def run_stage(dev) -> dict:
    """The guidance stage on one image, as a user runs it: guidance/run.py's
    run_hunyuan_w_guid on synthetic artifacts written to a temporary directory
    (a 512^2 RGBA crop, hand and object masks, a 384x512 MoGe grid mesh with
    fov.json, T_h2m, the synthetic hand as the aligned MANO mesh, the HaMeR
    keypoints and J_regressor_hamer.npy), with the full-width DiT, ShapeVAE and
    DINOv2-G and the default OptimizationConfig: build_targets (the MoGe mesh
    through K3), the conditioner (K1 at [1,24,1370,64]), GuidedSampler.run (20
    CFG steps; 200 hand, 100 object and 9 x 50 joint iterations), the 384^3
    export (two-level decode, host compose and marching tets) and the
    post-processing, then the two PLYs.

    The stage's functions are wrapped here, not changed, to time each part
    and keep what the checks read (the GuidanceResult, the export's refine
    ids). With random weights a falling object loss is not required; the run
    must finish with finite loss curves of full length, an object pose and a
    noise prediction that the optimizers moved, both PLYs written, and every
    kernel launched as often as the stage calls it."""
    import tempfile

    from PIL import Image

    from followmyhold_tpu_torch.configs.guidance import OptimizationConfig
    from followmyhold_tpu_torch.diffusion import guidance
    from followmyhold_tpu_torch.diffusion.guidance import GuidedSampler
    from followmyhold_tpu_torch.geometry.hunyuan import build_models, encode_condition
    from followmyhold_tpu_torch.guidance import run as stage
    from followmyhold_tpu_torch.models import hunyuan, vit
    from followmyhold_tpu_torch.models.hunyuan import (
        COND_FULL,
        DIT_FULL,
        VAE_FULL,
        refine_point_ids_host,
    )
    from followmyhold_tpu_torch.ops import _kernels
    from followmyhold_tpu_torch.ops.attention import attention_plain
    from followmyhold_tpu_torch.ops.camera import GuidanceCamera
    from followmyhold_tpu_torch.tools._scene import write_stage_inputs
    from followmyhold_tpu_torch.utils.mesh_io import load_mesh

    t0 = time.perf_counter()
    dit, vae, cond = build_models(DIT_FULL, VAE_FULL, COND_FULL, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in m.parameters()) / 1e9
                for name, m in (("dit", dit), ("vae", vae), ("conditioner", cond))}
    say(f"main: built DiT + ShapeVAE + DINOv2-G at full width ({n_params}, billions of "
        f"parameters) in {time.perf_counter() - t0:.1f} s")

    root = tempfile.mkdtemp(prefix="fmh_stage_")
    d = write_stage_inputs(root, image_id=IMAGE_ID, size=512, moge_grid=(384, 512),
                           hoi_ids=HOI_IDS)
    crop = os.path.join(d["cropped_obj_img_dir"], f"{IMAGE_ID}_cropped_inpainted.png")
    rgba = np.asarray(Image.open(crop).convert("RGBA"))

    # the conditioner with K1 against the same forward with the plain attention
    tokens, uncond = encode_condition(cond, rgba, device=dev)
    with_kernel = vit.multi_head_attention
    vit.multi_head_attention = lambda q, k, v, device=None: attention_plain(
        q, k, v, scale=1.0 / math.sqrt(q.shape[-1]))
    try:
        plain_tokens, _ = encode_condition(cond, rgba, device=dev)
    finally:
        vit.multi_head_attention = with_kernel
    cond_rel = _rel_err(tokens, plain_tokens)
    if not (math.isfinite(cond_rel) and cond_rel <= _COND_REL_LIMIT):
        fail(f"conditioner tokens with K1 differ from the plain attention's by {cond_rel} "
             f"relative (limit {_COND_REL_LIMIT})")
    say(f"main: conditioner tokens {list(tokens.shape)} with K1 against the plain attention: "
        f"relative {cond_rel:.2e} (limit {_COND_REL_LIMIT:.2e})")
    field = _shape_field(dev, dit, vae, tokens, uncond)
    say(f"main: shaped the random-weight field (lowest Fourier frequency; logit shift "
        f"{field['logit_shift']:.4f}, spread {field['spread']:.4f} over the box)")
    hoi = run_hoi_stages(dev, (dit, vae, cond), d, root)

    # the two reduced runs on the stage's own targets
    camera = GuidanceCamera(height=512, width=512, fov_deg=60.0)
    j_reg = np.load(os.path.join(d["hamer_out_dir"], "J_regressor_hamer.npy"))
    args = dict(
        cropped_obj_img_path=crop, fovx=60.0,
        hamer_for_guid_path=os.path.join(d["hamer_out_dir"], f"{IMAGE_ID}_kps_for_guidance.npy"),
        aligned_mano_mesh_path=os.path.join(d["aligned_mano_dir"],
                                            f"{IMAGE_ID}_hamer_aligned_mano.ply"),
        cropped_obj_mask_path=os.path.join(d["mask_dir"], f"{IMAGE_ID}_cropped_obj_mask.png"),
        cropped_hand_mask_path=os.path.join(d["mask_dir"], f"{IMAGE_ID}_cropped_hand_mask.png"),
        moge_mesh_path=os.path.join(d["moge_out_dir"], f"{IMAGE_ID}_cropped_hoi", "mesh.ply"),
        T_h2m_path=os.path.join(d["h2m_rt_dir"], f"{IMAGE_ID}_hoi_mesh.npy"),
        hunyuan_hoi_mesh_path=os.path.join(d["hunyuan_hoi_mesh_dir"], f"{IMAGE_ID}_hoi_mesh.ply"),
        save_path_obj=os.path.join(d["guidance_out_dir"], f"{IMAGE_ID}_obj.ply"),
        save_path_hand=os.path.join(d["guidance_out_dir"], f"{IMAGE_ID}_hand.ply"))
    targets = stage.build_targets(
        camera, args["aligned_mano_mesh_path"], args["T_h2m_path"], args["moge_mesh_path"],
        stage._load_mask(args["cropped_hand_mask_path"]),
        stage._load_mask(args["cropped_obj_mask_path"]), args["hamer_for_guid_path"], j_reg,
        device=dev)
    check_two_runs(dev, dit, vae, camera, targets, tokens, uncond)
    del targets

    # ---- the main path: one image through the stage ---------------------- #
    calls, kept = {}, {}
    originals = {name: getattr(stage, name) for name in (
        "build_targets", "encode_condition", "remove_floaters", "remove_degenerate_faces",
        "reduce_faces")}
    run_orig, export_orig = GuidedSampler.run, GuidedSampler.export_meshes
    decode_orig = hunyuan.vae_query_logits_hierarchical
    compose_orig = hunyuan.compose_hierarchical_grid
    extract_orig = guidance.marching_tets_host

    def encode(*a, **k):
        before = _kernels.LAUNCH_COUNTS["flash_attention_fwd"]
        out = _timed(originals["encode_condition"], calls, "conditioner")(*a, **k)
        kept["conditioner_k1"] = _kernels.LAUNCH_COUNTS["flash_attention_fwd"] - before
        kept["cond"] = torch.cat(out, dim=0)
        return out

    def sampler_run(self, *a, **k):
        kept["sampler"] = self
        kept["result"] = _timed(run_orig, calls, "sampler")(self, *a, **k)
        return kept["result"]

    def export(self, *a, **k):
        out = _timed(export_orig, calls, "export")(self, *a, **k)
        kept["faces_exported"] = int(out[0].num_faces)
        return out

    def decode(*a, **k):
        out = _timed(decode_orig, calls, "export_decode")(*a, **k)
        kept["export"] = dict(g_c=out[0].cpu().numpy(), pt_ids=out[1].cpu().numpy(),
                              n_selected=out[3], n_points=out[4])
        return out

    def counted(name):
        def fn(verts, faces, *a, **k):
            out = _timed(originals[name], calls, name)(verts, faces, *a, **k)
            kept[f"faces_after_{name}"] = len(out[1])
            return out
        return fn

    def reduce(verts, faces, *a, **k):
        kept["faces_before_reduce"] = len(faces)
        out = _timed(originals["reduce_faces"], calls, "reduce_faces")(verts, faces, *a, **k)
        kept["faces_after_reduce"] = len(out[1])
        return out

    stage.build_targets = _timed(originals["build_targets"], calls, "build_targets")
    stage.encode_condition = encode
    stage.remove_floaters = counted("remove_floaters")
    stage.remove_degenerate_faces = counted("remove_degenerate_faces")
    stage.reduce_faces = reduce
    GuidedSampler.run, GuidedSampler.export_meshes = sampler_run, export
    hunyuan.vae_query_logits_hierarchical = decode
    hunyuan.compose_hierarchical_grid = _timed(compose_orig, calls, "export_compose")
    guidance.marching_tets_host = _timed(extract_orig, calls, "host_extraction")
    config = OptimizationConfig()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        obj_out, hand_out = stage.run_hunyuan_w_guid(
            **args, config=config, models=(dit, vae, cond), j_regressor=j_reg, device=dev)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        launches = _kernels.launch_counts()
    finally:
        for name, fn in originals.items():
            setattr(stage, name, fn)
        GuidedSampler.run, GuidedSampler.export_meshes = run_orig, export_orig
        hunyuan.vae_query_logits_hierarchical = decode_orig
        hunyuan.compose_hierarchical_grid = compose_orig
        guidance.marching_tets_host = extract_orig
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    secs = {key: sum(times) for key, times in calls.items()}
    result, sampler, ex = kept["result"], kept["sampler"], kept["export"]

    # ---- what the stage reports ------------------------------------------ #
    post_s = secs["remove_floaters"] + secs["remove_degenerate_faces"] + secs["reduce_faces"]
    write_s = stage_s - sum(secs[k] for k in ("build_targets", "conditioner", "sampler",
                                               "export")) - post_s
    export_parts = ("export_decode", "export_compose", "host_extraction")
    split = dict(conditioner=secs["conditioner"], build_targets=secs["build_targets"],
                 sampler=secs["sampler"], **{k: secs[k] for k in export_parts},
                 export_rest=secs["export"] - sum(secs[k] for k in export_parts),
                 postprocess=post_s, reading_and_writing=write_s)
    say(f"main: stage {stage_s:.2f} s per image: " + ", ".join(
        f"{k} {v:.4f} s" for k, v in split.items()))
    say(f"main: postprocess: floaters {secs['remove_floaters']:.3f} s, degenerate faces "
        f"{secs['remove_degenerate_faces']:.3f} s, reduce_faces {secs['reduce_faces']:.3f} s; "
        f"faces: {kept['faces_exported']} exported, {kept['faces_after_remove_floaters']} "
        f"after the floaters, {kept['faces_before_reduce']} after the degenerate faces (before "
        f"reduce_faces), {kept['faces_after_reduce']} after reduce_faces; export: "
        f"{ex['n_selected']} surface cells, {ex['n_points']} refine points")

    n_steps = config.num_inference_steps
    n_hand, n_obj = config.optimization_steps_hand, config.optimization_steps_scale
    n_joint_phases = n_steps - config.handopt_start_step - 2
    n_joint = config.optimization_steps_joint * n_joint_phases
    n_blocks = DIT_FULL.depth_double + DIT_FULL.depth_single
    sec = result.seconds
    dit_s = sec["dit_steps"]
    say(f"main: sampler {secs['sampler']:.2f} s (DiT step median "
        f"{float(np.median(dit_s)):.4f} s, first {dit_s[0]:.4f} s; hand phase "
        f"{sec['hand']:.2f} s = {sec['hand'] / n_hand * 1e3:.2f} ms/iteration; object phase "
        f"{sec['obj']:.2f} s = {sec['obj'] / n_obj * 1e3:.2f} ms/iteration; joint phases "
        f"{sec['joint']:.2f} s = {sec['joint'] / n_joint * 1e3:.2f} ms/iteration), "
        f"peak memory {peak_gb:.2f} GiB")

    curves = {tag: c.float().cpu() for tag, c in result.losses.items()}
    want_len = {"hand": n_hand, "obj": n_obj}
    want_len.update({f"joint_{i}": config.optimization_steps_joint
                     for i in range(config.handopt_start_step + 2, n_steps)})
    for tag, c in curves.items():
        say(f"main: {tag} loss first {c[0].item():.5f} last {c[-1].item():.5f} "
            f"min {c.min().item():.5f}")
    moved = _noise_moved(sampler, result, kept["cond"], n_steps)
    say(f"main: object pose scale {result.obj.scale.tolist()} trans {result.obj.trans.tolist()} "
        f"quat {result.obj.quat.tolist()}; the joint phase moved the noise prediction by "
        f"{moved:.4f}; launches {launches} (the conditioner's K1 {kept['conditioner_k1']})")

    # ---- checks -------------------------------------------------------------- #
    for path in (args["save_path_obj"], args["save_path_hand"]):
        if not (os.path.exists(path) and os.path.getmtime(path) >= t0 - 1.0):
            fail(f"{path} was not written by this run")
    obj_ply, hand_ply = load_mesh(args["save_path_obj"]), load_mesh(args["save_path_hand"])
    if not (obj_ply.num_faces > 0 and np.isfinite(obj_ply.vertices).all()
            and hand_ply.num_vertices == 778 and np.isfinite(hand_ply.vertices).all()):
        fail(f"the PLYs are empty or not finite: object {obj_ply.num_vertices} verts "
             f"{obj_ply.num_faces} faces, hand {hand_ply.num_vertices} verts")
    if obj_out is None or len(obj_out[1]) != obj_ply.num_faces:
        fail("the stage's object mesh and the PLY it wrote differ")
    say(f"main: wrote {IMAGE_ID}_obj.ply ({obj_ply.num_vertices} verts, {obj_ply.num_faces} "
        f"faces) and {IMAGE_ID}_hand.ply ({hand_ply.num_vertices} verts)")
    host_ids = refine_point_ids_host(ex["g_c"], config.final_octree_resolution)
    if not np.array_equal(host_ids, ex["pt_ids"]):
        fail(f"the export's refine ids differ between the device ({ex['pt_ids'].size}) and "
             f"the host twin ({host_ids.size})")
    say(f"main: the export's {host_ids.size} refine ids are the same on the device and the host")
    if sorted(curves) != sorted(want_len):
        fail(f"loss curves of phases {sorted(curves)}, expected {sorted(want_len)}")
    for tag, c in curves.items():
        if c.numel() != want_len[tag] or not torch.isfinite(c).all():
            fail(f"{tag} loss curve is incomplete or not finite")
    if not curves["hand"][-1].item() < curves["hand"][0].item():
        fail(f"hand loss did not decrease: {curves['hand'][0].item()} -> "
             f"{curves['hand'][-1].item()}")
    if not all(torch.isfinite(x).all() for x in (result.latents, result.noise_pred,
                                                  *result.hand, *result.obj)):
        fail("non-finite latents, noise prediction or poses")
    if torch.allclose(result.obj.quat.cpu(), torch.tensor([1.0, 0.0, 0.0, 0.0])) or \
            torch.allclose(result.obj.trans.cpu(), torch.zeros(3)):
        fail("the object pose did not move")
    if not moved > 1e-3:
        fail(f"the joint phase did not move the noise prediction ({moved})")
    if tuple(result.latents.shape) != (1, VAE_FULL.num_latents, VAE_FULL.embed_dim):
        fail(f"latents have shape {tuple(result.latents.shape)}")
    if kept["conditioner_k1"] < COND_FULL.depth:
        fail(f"the conditioner launched K1 {kept['conditioner_k1']} times, expected at least "
             f"{COND_FULL.depth}")
    if launches["flash_attention_fwd"] < n_blocks * n_steps + COND_FULL.depth:
        fail(f"flash attention launched {launches['flash_attention_fwd']} times, expected at "
             f"least {n_blocks * n_steps + COND_FULL.depth}")
    # one backward per ShapeVAE self-attention block in every object/joint iteration
    want_bwd = VAE_FULL.depth * (n_obj + n_joint)
    if launches["flash_attention_bwd"] < want_bwd:
        fail(f"flash attention backward launched {launches['flash_attention_bwd']} times, "
             f"expected at least {want_bwd}")
    # one render per hand and object iteration, two (hand alone, then the scene)
    # per joint iteration, and build_targets' MoGe render
    want_raster = n_hand + n_obj + 2 * n_joint + 1
    if launches["raster_fwd"] < want_raster or launches["raster_bwd"] < want_raster - 1:
        fail(f"rasterizer launched {launches['raster_fwd']} / {launches['raster_bwd']} times, "
             f"expected at least {want_raster} / {want_raster - 1}")
    if launches["raster_chunk_plan"] < want_raster:
        fail(f"the raster chunk plan launched {launches['raster_chunk_plan']} times, expected "
             f"at least {want_raster}")
    # the backward of every render scatters the two per-pixel gathers (corners, normals)
    if launches["scatter_rows_add"] < 2 * (want_raster - 1):
        fail(f"scatter_rows_add launched {launches['scatter_rows_add']} times, expected at "
             f"least {2 * (want_raster - 1)}")
    shutil.rmtree(root, ignore_errors=True)
    batched = run_batched_stage(dev, (dit, vae, cond))
    return dict(launches=launches, hoi=hoi, batched=batched)


# the batched run's two images: the main path's image (its crop, its noise stream) and
# a second one, at two fields of view
BATCH_IDS = (IMAGE_ID, "000002")
BATCH_FOVS = (50.0, 70.0)
# each image's CFG noise prediction from the DiT at batch 4 (both images) against its
# own at batch 2: the GEMMs of the two batch sizes may tile the sums apart, one bf16
# rounding step (2^-8) of the outputs that differ, compounding over the DiT's blocks as
# the conditioner's 40 layers compounded K1's (7.8e-3), and the CFG scale multiplies
# the difference of the conditional and unconditional predictions
_BATCH_REL_LIMIT = 2.0 ** -5


def run_batched_stage(dev, models) -> dict:
    """The guidance stage on two images in one batch, as a user runs it:
    guidance/run.run(batch_size=2) over two write_stage_inputs scenes at 50 and
    70 degrees (each image's field of view in its own targets), with the main
    path's full-width models (run's build_models hands them over: the
    ShapeVAE's field is shaped, see _shape_field), the default
    OptimizationConfig and the 384^3 export. The DiT runs once a step for both
    images (K1 at [4,16,4442,128]), the phases image by image, the exports in
    a two-worker pool. The launch counts are set to 0 just before and read
    just after. It prints s per image, the DiT step at batch 4 and ms per
    iteration; it checks both images' PLYs, that the two optimized poses
    differ, and each image's batched DiT prediction against its batch-2 one."""
    import tempfile

    from followmyhold_tpu_torch.configs.profiles import crop_size, optimization_config
    from followmyhold_tpu_torch.diffusion.guidance import GuidedSampler
    from followmyhold_tpu_torch.diffusion.pipeline import cfg_noise_pred
    from followmyhold_tpu_torch.guidance import run as stage
    from followmyhold_tpu_torch.models.hunyuan import COND_FULL, DIT_FULL, VAE_FULL
    from followmyhold_tpu_torch.ops import _kernels
    from followmyhold_tpu_torch.tools._scene import write_stage_inputs
    from followmyhold_tpu_torch.utils.mesh_io import load_mesh

    root = tempfile.mkdtemp(prefix="fmh_batch_")
    for k, (image_id, fov) in enumerate(zip(BATCH_IDS, BATCH_FOVS)):
        size = crop_size()
        d = write_stage_inputs(root, image_id=image_id, size=size,
                               moge_grid=(size * 3 // 4, size), fov_deg=fov, seed=k)
    dirs = [d[k] for k in ("cropped_obj_img_dir", "mask_dir", "moge_out_dir",
                           "hunyuan_hoi_mesh_dir", "hamer_out_dir", "h2m_rt_dir",
                           "aligned_mano_dir", "guidance_out_dir")]
    calls, kept = {}, {}
    run_batch_orig, build_orig = GuidedSampler.run_batch, stage.build_models
    export_orig = stage._export_and_write

    def run_batch(self, cond_main, uncond_main, *a, **k):
        kept["cond"], kept["sampler"] = (cond_main, uncond_main), self
        kept["result"] = _timed(run_batch_orig, calls, "sampler")(self, cond_main, uncond_main,
                                                                    *a, **k)
        return kept["result"]

    GuidedSampler.run_batch = run_batch
    stage.build_models = lambda *a, **k: models
    stage._export_and_write = _timed(export_orig, calls, "export")
    try:
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stage.run(root, *dirs, batch_size=2, device=dev)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        launches = _kernels.launch_counts()
    finally:
        GuidedSampler.run_batch, stage.build_models = run_batch_orig, build_orig
        stage._export_and_write = export_orig
    if "result" not in kept:
        fail("the batched run did not reach GuidedSampler.run_batch")
    result, n = kept["result"], len(BATCH_IDS)
    config = optimization_config()   # the stage's
    n_hand, n_obj = config.optimization_steps_hand, config.optimization_steps_scale
    n_joint = config.optimization_steps_joint * (config.num_inference_steps
                                                 - config.handopt_start_step - 2)
    sec, dit_s = result.seconds, result.seconds["dit_steps"]
    say(f"batch: guidance stage on {n} images in one batch ({dict(zip(BATCH_IDS, BATCH_FOVS))} "
        f"degrees) {stage_s:.2f} s, {stage_s / n:.2f} s per image: sampler "
        f"{calls['sampler'][0]:.2f} s (DiT step at batch {2 * n} median "
        f"{float(np.median(dit_s)):.4f} s, first {dit_s[0]:.4f} s; hand "
        f"{sec['hand'] / (n * n_hand) * 1e3:.2f}, object {sec['obj'] / (n * n_obj) * 1e3:.2f}, "
        f"joint {sec['joint'] / (n * n_joint) * 1e3:.2f} ms per image and iteration); exports "
        f"(two at once) {', '.join(f'{x:.2f}' for x in calls['export'])} s; launches {launches}")

    # ---- checks -------------------------------------------------------------- #
    for image_id in BATCH_IDS:
        paths = [os.path.join(d["guidance_out_dir"], f"{image_id}_{part}.ply")
                 for part in ("obj", "hand")]
        if not all(os.path.exists(p) and os.path.getmtime(p) >= t0 - 1.0 for p in paths):
            fail(f"the batched run did not write both PLYs of {image_id}")
        obj_ply, hand_ply = load_mesh(paths[0]), load_mesh(paths[1])
        if not (obj_ply.num_faces > 0 and np.isfinite(obj_ply.vertices).all()
                and hand_ply.num_vertices == 778 and np.isfinite(hand_ply.vertices).all()):
            fail(f"{image_id}'s PLYs of the batched run are empty or not finite")
        say(f"batch: wrote {image_id}_obj.ply ({obj_ply.num_faces} faces) and "
            f"{image_id}_hand.ply")
    for tag, curve in result.losses.items():
        if not (curve.shape[0] == n and torch.isfinite(curve).all()):
            fail(f"batched {tag} loss curves {tuple(curve.shape)} are not finite per image")
    moved = {name: max((x[0] - x[1]).abs().max().item() for x in getattr(result, name))
             for name in ("hand", "obj")}
    if not min(moved.values()) > 1e-4:
        fail(f"the two images' optimized poses do not differ: {moved}")
    cond_main, uncond_main = kept["cond"]
    lat = result.latents[:, 0]
    g, t = config.obj_guidance_scale, 0.5
    together = cfg_noise_pred(models[0], torch.cat([cond_main[:, 0], uncond_main[:, 0]]), lat,
                              t, g)
    rel = [_rel_err(together[b:b + 1], cfg_noise_pred(
        models[0], torch.cat([cond_main[b], uncond_main[b]]), lat[b:b + 1], t, g))
        for b in range(n)]
    if not all(math.isfinite(r) and r <= _BATCH_REL_LIMIT for r in rel):
        fail(f"the batched DiT prediction differs from each image's batch-2 one by {rel} "
             f"relative (limit {_BATCH_REL_LIMIT})")
    say(f"batch: the two images' poses differ (hand by {moved['hand']:.4f}, object by "
        f"{moved['obj']:.4f}); each image's DiT prediction at batch {2 * n} against batch 2: "
        f"relative {[f'{r:.2e}' for r in rel]} (limit {_BATCH_REL_LIMIT:.2e})")
    n_blocks = DIT_FULL.depth_double + DIT_FULL.depth_single
    want = {"flash_attention_fwd": n_blocks * config.num_inference_steps + n * COND_FULL.depth,
            "flash_attention_bwd": n * VAE_FULL.depth * (n_obj + n_joint),
            "raster_fwd": n * (n_hand + n_obj + 2 * n_joint + 1)}
    short = {k: (launches[k], v) for k, v in want.items() if launches[k] < v}
    if short:
        fail(f"the batched run launched kernels fewer times than it runs them: {short}")
    shutil.rmtree(root, ignore_errors=True)
    return dict(launches=launches, seconds=stage_s, sampler_seconds=sec, calls=calls,
                dit_rel=rel)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check the kernels, skip the models")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU and has no CPU mode")
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from followmyhold_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _, reports = _kernels.build_library(verbose=True)
    _kernels.load_library()
    say(f"build: kernels compiled and loaded in {time.perf_counter() - t0:.1f} s")
    from followmyhold_tpu_torch import native

    t0 = time.perf_counter()
    native.get_lib()
    say(f"build: the native host library (g++) built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    # a spill or a serialised wgmma costs the kernels their design's speed
    for src, report in reports.items():
        if "serialized" in report or re.search(r"[1-9]\d* bytes spill", report):
            fail(f"ptxas reports spills or serialised wgmma instructions in {src}")

    kernels = [check_flash_attention(dev), check_flash_attention_backward(dev),
               *check_rasterizer(dev)]
    launches = launches_inpaint = launches_hoi = launches_moge = launches_batch = {
        k["name"]: 0 for k in kernels}
    if not args.kernels_only:
        launches_inpaint = run_inpaint_stage(dev)["launches"]
        ran = run_stage(dev)
        launches, hoi = ran["launches"], ran["hoi"]
        launches_hoi, launches_moge = hoi["launches"], hoi["moge"]["launches"]
        launches_batch = ran["batched"]["launches"]
        for k, overlay in zip(kernels[-3:-1], hoi["raster_overlay"]):
            k["overlay_mesh"] = overlay
        profile_flux_step(dev)
    for k in kernels:
        # launches: the guidance stage's run of one image; launches_stage_3, _stage_4,
        # _stages_5_8 and _batched: the runs of stage 3, of stage 4, of stages 5-8 and of
        # the batched guidance
        k["launches"] = launches[k["name"]]
        k["launches_stage_3"] = launches_inpaint[k["name"]]
        k["launches_stage_4"] = launches_moge[k["name"]]
        k["launches_stages_5_8"] = launches_hoi[k["name"]]
        k["launches_batched"] = launches_batch[k["name"]]

    say(json.dumps({"kernels": kernels}))
    say(smi)
    if args.kernels_only:
        say("kernels-only run: main path skipped")
        return
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
