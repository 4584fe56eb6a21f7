#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py               # everything (what a checkout is judged by)
    python3 chip_smoke.py --kernels-only  # build + kernel checks, no models

Phases, each printing one line; any failure ends the run with a non-zero code:

1. device   require CUDA; print the card's name and power limit.
2. build    compile the CUDA kernels from followmyhold_tpu_torch/csrc with nvcc;
            ptxas must report no spills and no serialised wgmma.
3. kernels  call every kernel's wrapper at the shapes the main path gives it
            and hold the result against its plain PyTorch version on the same
            inputs; time kernel, plain version and, for attention, PyTorch's
            scaled_dot_product_attention as a yardstick (the port never calls it).
4. main     full-width Hunyuan3D-2 DiT + ShapeVAE with seeded random weights:
            GuidedSampler.run with the default OptimizationConfig (20 CFG
            steps; 200 hand-pose Adam steps, 100 object-phase and 9 x 50
            joint-phase AdamW steps, each through the ShapeVAE decode and its
            backward, marching tets, render and losses; scheduler advance)
            and export_meshes at 64^3. The kernels' launch counts are set to
            0 just before and read just after.
5. result   a `kernels` JSON line, the nvidia-smi line, and the `ok` JSON line.

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
  shape runs the masks.
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
- rasterizer forward: winner slots must agree on all but 0.1 % of the pixels
  (the arithmetic is bit-identical by construction; the margin is for depth
  ties). Where they agree, w1, w2 to 1e-5 and vis to 1e-4 (the visibility
  product is taken in another order).
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
import re
import subprocess
import sys
import time

import numpy as np
import torch

# published peaks of one H100 SXM (dense)
_BF16_FLOPS = 989e12
_F32_FLOPS = 67e12
_HBM_BYTES = 3.35e12
# f32 operations per (pixel, face) pair, counted from the kernels' arithmetic
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

    shapes = [  # (label, B, H, N, M, D); the first has most launches on the main path
        ("vae_self", 1, 16, 3072, 3072, 64),
        ("geo_cross", 4, 16, 8192, 3072, 64),
        ("dit_joint", 2, 16, 4442, 4442, 128),
        ("ragged", 1, 16, 3000, 2900, 64),   # the kv mask, zero-filled rows, rows past N
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
            plain_ms = cuda_ms(lambda: A.flash_attention_plain(q, k, v, scale), 1, 2)
            lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=scale), 2, 10)
        flops = 4.0 * B * H * N * M * D
        nbytes = 2.0 * B * H * D * (2 * N + 2 * M) + 4.0 * B * H * N
        t_ops, t_bytes = flops / _BF16_FLOPS * 1e3, nbytes / _HBM_BYTES * 1e3
        per_shape.append(dict(
            shape=label, dims=[B, H, N, M, D], max_abs_err=err_o, rel_err=rel,
            rel_err_one_tile_missing=fault, lse_max_abs_err=err_l,
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            tflops=flops / ms / 1e9))
        say(f"kernel flash_attention_fwd {label} {[B, H, N, M, D]}: err_O {err_o:.3e} relative "
            f"{rel:.2e} (limit {_FWD_REL_LIMIT:.2e}; one kv tile missing {fault:.2e}) err_lse "
            f"{err_l:.3e}; same bits in two calls; kernel {ms:.3f} ms "
            f"({flops / ms / 1e9:.0f} TFLOP/s, {ms / lib_ms:.2f}x sdpa) plain {plain_ms:.3f} ms "
            f"sdpa {lib_ms:.3f} ms bound {max(t_ops, t_bytes):.3f} ms")
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    head = per_shape[0]
    return dict(name="flash_attention_fwd", route="cuda",
                source="followmyhold_tpu_torch/csrc/flash_attention_fwd.cu",
                replaces="followmyhold_tpu/ops/attention.py:108",
                max_abs_err=max(s["max_abs_err"] for s in per_shape),
                ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"], shapes=per_shape)


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
    """The (geom, tile_start, meta) that rasterize() hands to the kernels."""
    from followmyhold_tpu_torch.ops.rasterizer import bin_and_pack

    packed = bin_and_pack(camera, verts, faces, torch.ones(faces.shape[0], device=verts.device),
                          0.7, faces_per_tile)
    return packed.geom, packed.tile_start, packed.meta


def _raster_bound(tile_start, n_ops: int, n_column_bytes: int, n_pixel_bytes: int) -> tuple:
    """Least time for this run's lists: every (tile, face) column of 9 floats and
    every pixel's values move once; every (pixel, face) pair costs n_ops."""
    columns = float((tile_start[1:] - tile_start[:-1]).double().sum().item())
    pairs = columns * 256.0
    T = tile_start.numel() - 1
    nbytes = columns * n_column_bytes + T * 256.0 * n_pixel_bytes
    t_ops, t_bytes = pairs * n_ops / _F32_FLOPS * 1e3, nbytes / _HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), pairs


def _compare_forward(tag, got, ref):
    w1, w2, slot, vis = got
    rw1, rw2, rslot, rvis = ref
    same = slot == rslot
    mismatch = 1.0 - same.float().mean().item()
    if mismatch > 1e-3:
        fail(f"raster forward {tag}: winner slots differ on {mismatch:.2%} of the pixels")
    err_w = max((w1 - rw1)[same].abs().max().item(), (w2 - rw2)[same].abs().max().item())
    err_v = (vis - rvis).abs().max().item()
    if not (err_w <= 1e-5 and err_v <= 1e-4):
        fail(f"raster forward {tag}: w differs by {err_w}, vis by {err_v}")
    return max(err_w, err_v), mismatch


def check_rasterizer(dev) -> list:
    from followmyhold_tpu_torch.ops import rasterizer as R
    from followmyhold_tpu_torch.ops.surface import PaddedMesh, marching_tets, vertex_normals
    from followmyhold_tpu_torch.ops.grid import generate_dense_grid_points
    from followmyhold_tpu_torch.tools._scene import hand_scene

    # --- the hand mesh at 512^2: forward and backward, tile level ---------- #
    mano, verts, camera, _ = hand_scene(dev, 512)
    faces = mano.faces
    geom, tile_start, meta = _tile_inputs(camera, verts, faces, 2048)
    got = R.raster_tiles_forward(geom, tile_start, meta)
    torch.cuda.synchronize()
    geom_p = geom.clone().requires_grad_(True)
    ref = R.raster_tiles_plain(geom_p, tile_start, meta)
    err_f, mismatch = _compare_forward("hand", got, ref)

    gen = torch.Generator(device=dev).manual_seed(7)
    gw1, gw2, gvis = (torch.randn(got[0].shape, generator=gen, device=dev) for _ in range(3))
    dgeom = R.raster_tiles_backward(geom, tile_start, got[2], got[3], gw1, gw2, gvis, meta)
    torch.cuda.synchronize()
    (ref_dgeom,) = torch.autograd.grad(
        (ref[0] * gw1).sum() + (ref[1] * gw2).sum() + (ref[3] * gvis).sum(), geom_p)
    ref_max = ref_dgeom.abs().max().item()
    diff_b = (dgeom - ref_dgeom).abs()
    err_b = diff_b.max().item()
    loose_b = (diff_b > 1e-4 * ref_max + 1e-6).float().mean().item()
    if not (math.isfinite(err_b) and err_b <= 2e-2 * ref_max and loose_b <= 1e-2):
        fail(f"raster backward hand: dgeom differs by {err_b} (max|ref| {ref_max}), "
             f"{loose_b:.2%} of the entries beyond 1e-4 of the maximum")

    fwd_ms = cuda_ms(lambda: R.raster_tiles_forward(geom, tile_start, meta), 2, 20)
    bwd_ms = cuda_ms(lambda: R.raster_tiles_backward(
        geom, tile_start, got[2], got[3], gw1, gw2, gvis, meta), 2, 20)
    with torch.no_grad():
        plain_fwd_ms = cuda_ms(lambda: R.raster_tiles_plain(geom, tile_start, meta), 1, 2)

    def plain_fwd_bwd():
        g = geom.clone().requires_grad_(True)
        o = R.raster_tiles_plain(g, tile_start, meta)
        torch.autograd.grad((o[0] * gw1).sum() + (o[1] * gw2).sum() + (o[3] * gvis).sum(), g)

    # the plain backward alone: forward + backward, less the forward timed above
    plain_bwd_ms = cuda_ms(plain_fwd_bwd, 1, 2) - plain_fwd_ms
    fwd_bound, fwd_by, pairs = _raster_bound(tile_start, _RASTER_FWD_OPS, 36, 16)
    bwd_bound, bwd_by, _ = _raster_bound(tile_start, _RASTER_BWD_OPS, 72, 20)
    say(f"kernel raster_fwd hand 512^2 F={faces.shape[0]} P={geom.shape[1]}: err {err_f:.3e} "
        f"slot mismatch {mismatch:.2e} kernel {fwd_ms:.3f} ms plain {plain_fwd_ms:.3f} ms "
        f"bound {fwd_bound:.4f} ms")
    say(f"kernel raster_bwd hand 512^2: err {err_b:.3e} (max|ref| {ref_max:.3e}, "
        f"{loose_b:.2e} of the entries beyond 1e-4 of it) kernel {bwd_ms:.3f} ms plain "
        f"{plain_bwd_ms:.3f} ms bound {bwd_bound:.4f} ms")

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
        f"{err_gn:.3e}, coverage {covered:.3f}")

    # --- a ~60k-face object mesh at 512^2: forward only -------------------- #
    xyz, _, _ = generate_dense_grid_points([-1.1] * 3, [1.1] * 3, 64, device=dev)
    sphere = marching_tets(xyz.norm(dim=-1) - 0.8, [-1.1] * 3, [1.1] * 3, 64)
    nf = sphere.num_faces
    obj_verts = sphere.verts * 0.25 + torch.tensor([0.0, 0.0, -0.8], device=dev)
    geom_o, tile_start_o, meta_o = _tile_inputs(camera, obj_verts, sphere.faces[:nf], 24576)
    got_o = R.raster_tiles_forward(geom_o, tile_start_o, meta_o)
    torch.cuda.synchronize()
    with torch.no_grad():
        ref_o = R.raster_tiles_plain(geom_o, tile_start_o, meta_o)
    err_o, mismatch_o = _compare_forward("object", got_o, ref_o)
    obj_ms = cuda_ms(lambda: R.raster_tiles_forward(geom_o, tile_start_o, meta_o), 2, 20)
    with torch.no_grad():
        obj_plain_ms = cuda_ms(lambda: R.raster_tiles_plain(geom_o, tile_start_o, meta_o), 0, 1)
    bin_ms = cuda_ms(lambda: _tile_inputs(camera, obj_verts, sphere.faces[:nf], 24576), 1, 5)
    obj_bound, _, _ = _raster_bound(tile_start_o, _RASTER_FWD_OPS, 36, 16)
    say(f"kernel raster_fwd object 512^2 F={nf} P={geom_o.shape[1]}: err {err_o:.3e} slot "
        f"mismatch {mismatch_o:.2e} kernel {obj_ms:.3f} ms plain {obj_plain_ms:.3f} ms bound "
        f"{obj_bound:.4f} ms; "
        f"projecting, binning and packing it (torch ops) {bin_ms:.3f} ms")

    fwd = dict(name="raster_fwd", route="cuda",
               source="followmyhold_tpu_torch/csrc/raster_fwd.cu",
               replaces="followmyhold_tpu/ops/rasterizer.py:506",
               max_abs_err=max(err_f, err_o), ms=fwd_ms, plain_ms=plain_fwd_ms,
               bound_ms=fwd_bound, bound_by=fwd_by, library_ms=None,
               pixel_face_pairs=pairs, slot_mismatch=max(mismatch, mismatch_o),
               object_mesh=dict(faces=nf, ms=obj_ms, plain_ms=obj_plain_ms, bound_ms=obj_bound,
                                bin_and_pack_ms=bin_ms))
    bwd = dict(name="raster_bwd", route="cuda",
               source="followmyhold_tpu_torch/csrc/raster_bwd.cu",
               replaces="followmyhold_tpu/ops/rasterizer.py:530",
               max_abs_err=err_b, ms=bwd_ms, plain_ms=plain_bwd_ms, bound_ms=bwd_bound,
               bound_by=bwd_by, library_ms=None, pixel_face_pairs=pairs,
               vertex_grad_err=err_gv)
    return [fwd, bwd]


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


def run_main_path(dev) -> dict:
    """The default OptimizationConfig end to end: 20 CFG steps; at step 9 the
    hand phase (200 Adam steps); at step 10 the object phase (100 AdamW steps
    through step_final -> the two-level ShapeVAE decode -> marching tets ->
    render); at steps 11-19 the joint phase (50 AdamW steps each); then the
    export at 64^3.

    With random weights the decoded SDF is a noise field, so a falling object
    loss is not required (the object cannot fit the targets' silhouette); the
    run must instead finish with finite loss curves of full length, an object
    pose and a noise prediction that the optimizers moved, and every kernel
    launched as often as the phases call it."""
    from followmyhold_tpu_torch.configs.guidance import OptimizationConfig, guidance_mesh_caps
    from followmyhold_tpu_torch.diffusion.guidance import GuidedSampler
    from followmyhold_tpu_torch.geometry.hunyuan import build_models
    from followmyhold_tpu_torch.models.hunyuan import DIT_FULL, VAE_FULL
    from followmyhold_tpu_torch.ops import _kernels
    from followmyhold_tpu_torch.tools._scene import hand_scene

    size = 512
    t0 = time.perf_counter()
    dit, vae = build_models(DIT_FULL, VAE_FULL, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (dit, vae) for p in m.parameters())
    say(f"main: built DiT + ShapeVAE at full width, {n_params / 1e9:.2f} B parameters, "
        f"{time.perf_counter() - t0:.1f} s")

    # synthetic targets: the hand a third of the image wide, as in a hand-object crop
    _, _, camera, targets = hand_scene(dev, size)
    # random condition tokens stand in for the image conditioner (not ported yet)
    gen = torch.Generator(device=dev).manual_seed(1)
    cond = torch.randn((1, 1370, DIT_FULL.context_dim), generator=gen, device=dev)
    uncond = torch.zeros_like(cond)

    config = OptimizationConfig()
    sampler = GuidedSampler(dit=dit, vae=vae, camera=camera, config=config,
                            **guidance_mesh_caps())

    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = sampler.run(cond, uncond, targets, (VAE_FULL.num_latents, VAE_FULL.embed_dim),
                         generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    obj_mesh, hand_verts = sampler.export_meshes(result, targets, octree_resolution=64,
                                                 device=dev)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    launches = _kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    n_steps = config.num_inference_steps
    n_hand, n_obj = config.optimization_steps_hand, config.optimization_steps_scale
    n_joint_phases = n_steps - config.handopt_start_step - 2
    n_joint = config.optimization_steps_joint * n_joint_phases
    n_blocks = DIT_FULL.depth_double + DIT_FULL.depth_single
    sec = result.seconds
    dit_s = sec["dit_steps"]
    say(f"main: run {run_s:.2f} s (DiT step median {float(np.median(dit_s)):.4f} s, first "
        f"{dit_s[0]:.4f} s; hand phase {sec['hand']:.2f} s = "
        f"{sec['hand'] / n_hand * 1e3:.2f} ms/iteration; object phase {sec['obj']:.2f} s = "
        f"{sec['obj'] / n_obj * 1e3:.2f} ms/iteration; joint phases {sec['joint']:.2f} s = "
        f"{sec['joint'] / n_joint * 1e3:.2f} ms/iteration), export {export_s:.2f} s, "
        f"peak memory {peak_gb:.2f} GiB")

    curves = {tag: c.float().cpu() for tag, c in result.losses.items()}
    want_len = {"hand": n_hand, "obj": n_obj}
    want_len.update({f"joint_{i}": config.optimization_steps_joint
                     for i in range(config.handopt_start_step + 2, n_steps)})
    for tag, c in curves.items():
        say(f"main: {tag} loss first {c[0].item():.5f} last {c[-1].item():.5f} "
            f"min {c.min().item():.5f}")
    nv, nf = obj_mesh.num_verts, obj_mesh.num_faces
    moved = _noise_moved(sampler, result, torch.cat([cond, uncond]), n_steps)
    say(f"main: object pose scale {result.obj.scale.tolist()} trans {result.obj.trans.tolist()} "
        f"quat {result.obj.quat.tolist()}; the joint phase moved the noise prediction by "
        f"{moved:.4f}; object mesh {nv} verts {nf} faces; launches {launches}")

    if sorted(curves) != sorted(want_len):
        fail(f"loss curves of phases {sorted(curves)}, expected {sorted(want_len)}")
    for tag, c in curves.items():
        if c.numel() != want_len[tag] or not torch.isfinite(c).all():
            fail(f"{tag} loss curve is incomplete or not finite")
    if not curves["hand"][-1].item() < curves["hand"][0].item():
        fail(f"hand loss did not decrease: {curves['hand'][0].item()} -> "
             f"{curves['hand'][-1].item()}")
    if not all(torch.isfinite(x).all() for x in (result.latents, result.noise_pred,
                                                  *result.hand, *result.obj, hand_verts)):
        fail("non-finite latents, noise prediction or poses")
    if torch.allclose(result.obj.quat.cpu(), torch.tensor([1.0, 0.0, 0.0, 0.0])) or \
            torch.allclose(result.obj.trans.cpu(), torch.zeros(3)):
        fail("the object pose did not move")
    if not moved > 1e-3:
        fail(f"the joint phase did not move the noise prediction ({moved})")
    if tuple(result.latents.shape) != (1, VAE_FULL.num_latents, VAE_FULL.embed_dim):
        fail(f"latents have shape {tuple(result.latents.shape)}")
    if nv <= 0 or nf <= 0 or not torch.isfinite(obj_mesh.verts).all():
        fail(f"exported object mesh is empty or not finite ({nv} verts, {nf} faces)")
    if launches["flash_attention_fwd"] < n_blocks * n_steps:
        fail(f"flash attention launched {launches['flash_attention_fwd']} times, expected at "
             f"least {n_blocks * n_steps}")
    # one backward per ShapeVAE self-attention block in every object/joint iteration
    want_bwd = VAE_FULL.depth * (n_obj + n_joint)
    if launches["flash_attention_bwd"] < want_bwd:
        fail(f"flash attention backward launched {launches['flash_attention_bwd']} times, "
             f"expected at least {want_bwd}")
    # one render per hand and object iteration, two (hand alone, then the scene)
    # per joint iteration
    want_raster = n_hand + n_obj + 2 * n_joint
    if launches["raster_fwd"] < want_raster or launches["raster_bwd"] < want_raster:
        fail(f"rasterizer launched {launches['raster_fwd']} / {launches['raster_bwd']} times, "
             f"expected at least {want_raster} each")
    return launches


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
    # a spill or a serialised wgmma costs the kernels their design's speed
    for src, report in reports.items():
        if "serialized" in report or re.search(r"[1-9]\d* bytes spill", report):
            fail(f"ptxas reports spills or serialised wgmma instructions in {src}")

    kernels = [check_flash_attention(dev), check_flash_attention_backward(dev),
               *check_rasterizer(dev)]
    launches = {k["name"]: 0 for k in kernels}
    if not args.kernels_only:
        launches = run_main_path(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]

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
