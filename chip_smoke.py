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
            inputs (K3 and K4 also on two object images in one launch, each image
            against its own launch bit for bit); time kernel, plain version and, for attention, PyTorch's
            scaled_dot_product_attention as a yardstick (the port never calls it).
            Also the deterministic scatter-add behind every gather's gradient
            (ops/indexing.scatter_rows_add): no host sync, same bits in two
            calls, timed beside the atomic index_add_ it replaced. And the FLUX
            blocks' attention prologue (ops/rope.qk_norm_rope): QK RMS-norm, RoPE and
            the joint [txt, img] write at stage 3's shapes, held against its plain
            version, three mutants rejected (check_qk_norm_rope).
   entry    followmyhold_tpu_torch.entry.entry(): one CFG denoise step of the
            full-width DiT, as a harness calls it; K1 at [2,16,4442,128] exactly once
            in each of its 24 blocks, finite latents (run_entry_step).
   mesh     the port's device mesh (followmyhold_tpu_torch/parallel/mesh.py), every
            rank a process on the one card and the collectives through gloo (NCCL
            refuses two ranks on one card), before any later phase builds a model
            (see run_mesh_phase): (a) entry.dryrun_multichip(4), dp=2 x tp=2, the
            guidance train step of the tiny DiT and ShapeVAE, its losses against one
            process without a mesh; (b) entry()'s CFG step with the full-width DiT
            sharded over tp=2 (K1 at [2,8,4442,128], 24 a rank) against the entry
            phase's unsharded step, and the same in float32 with the plain attention;
            (c) guidance/run.run_batch_images over dp=2 on the batched stage's two
            scenes at full width (counts cut: MESH_DP_STEPS), each rank writing its
            own image's PLYs, the gathered result against run_batch without a mesh.
            Prints seconds by part, each rank's peak memory and the launches summed
            over the ranks.
   convert  the checkpoint converters (followmyhold_tpu_torch/convert), as a user runs
            them, in a temporary FOHO_TPU_ASSETS that is removed afterwards (see
            run_convert_phase): a Hunyuan3D-2 model.ckpt at full width and depth (the
            reference's names, fp16, seeded; tools._checkpoints) through
            convert.hunyuan's main, its three files loaded onto the card by
            geometry/hunyuan.build_models, every parameter equal to the in-memory
            bridge, and one CFG step of entry() on the loaded DiT (K1 24 times, the
            bridged DiT's bits); then every other converter at published width (the
            FLUX transformer and T5-XXL cut to 2 blocks), each loaded on the card and
            run once. Prints each part's seconds, GB/s and file sizes, and the host's
            and the card's peak memory.
4. detect   stage 2 on its learned path, as a user runs it where the four converted
            detector files exist: preprocess/get_hunyuan_input.run on tools._scene.hoi_photo
            (1280x960) with preprocess.detectors.LearnedBundle at full width and depth
            (YOLOv8-n; the Faster R-CNN, ResNet-101 with a bf16 trunk; GroundingDINO with
            Swin-B and BERT-base; SAM2 Hiera-L; seeded random weights, ~0.5 B parameters)
            and a synthetic WordPiece vocabulary: YOLO at 640^2, the Faster R-CNN at
            800x600 (22,800 anchors, 6,000 to NMS, at most 300 rois), GroundingDINO at
            800^2 and SAM2 at 1024^2 on the crop, for the object and for "only hand". No
            kernel of this repo runs there (the JAX package's detectors reach no
            pallas_call). Checks the stage's files, every output finite, the crop's union
            box inside the photo, the masks' shape and two calls of each bundle function
            giving the same bits; prints s per image by part, NMS candidate counts, host
            syncs per call and peak memory (see run_detect_phase). Its bundle stays for the
            next two phases and is freed before stage 3. The pipeline phase (9) keeps the
            heuristic bundle: that is what default_bundle picks without converted files,
            and detectors on random weights would feed the later stages arbitrary crops.
   hands    the hand stage's multi-hand chain on a raw 1280x960 frame of two people
            (tools._scene.two_person_frame), as a user runs it with --multi_hand: the
            detect phase's GroundingDINO as the person detector, ViTPose-H wholebody at
            full width and depth on each person, the per-side NMS, HaMeR ViT-H on every
            hand and the overlay of all of them through K3, held against its plain
            version; then the pipeline mode's box where a ViTPose file exists (the
            keypoint block's, not the mask's) on the HOI crops of stages 4-8. Its own
            launch counts; s per frame by part (see run_hands_phase).
   serve    followmyhold_tpu_torch/serve.py's server on 127.0.0.1 with the detect
            phase's bundle resident: GET /healthz, a 404, POST /segment against the
            bundle's own call (see run_serve_phase). Its POST /reconstruct is phase 9.
5. inpaint  stage 3 first, as the pipeline runs it: preprocess/inpaint.run on the two
            synthetic HOI crops and hand masks that stages 4-8 use, with FLUX.1-Kontext-dev,
            the FLUX VAE, CLIP-L and T5-XXL at full width and depth (bf16, seeded random
            weights built on the card, ~31.5 GiB) and synthetic tokenizer vocabularies, so
            that the prompt takes the checkpoint's path (77 CLIP and 512 T5 ids): 28 steps
            an image with K1 at [1,24,2560,128], 57 launches a step, and the attention
            prologue's kernel 76 launches a step. Its own launch counts;
            each {id}_inpainted_{rid}.png checked; the final latents finite; two 2-step
            kontext_edit calls must give the same bits; one full-width transformer forward
            with K1 held against the plain attention; s per image by part (tokenizing, T5
            and CLIP, VAE encode, the steps as one span and the median step, VAE decode,
            the PNG; the card's parts on CUDA events, with no host synchronisation added)
            and peak memory. The models are freed before stage 4. After the pipeline
            (9), the last timed phase, one step of a freshly built inpainter runs under
            torch.profiler: its device-busy share, K1's and the GEMM library's shares (a
            profiler session leaves the process's launches slower).
6. stages   stages 4-8 on two synthetic HOI crops (write_stage_inputs' hoi_ids; a
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
7. main     the guidance stage on one image, as a user runs it: guidance/run.py's
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
8. batch    the guidance stage on two images in one batch: guidance/run.run with
            batch_size=2 over two scenes at 50 and 70 degrees, with the same models
            and the default config (GuidedSampler.run_batch: the DiT at batch 4, each
            phase once for both images, K3 and K4 over both images' tiles in one
            launch; the exports two at once), with its own launch counts and peak
            memory; s per image beside phase 7's one image, and per iteration of each
            phase, batched and for one image: wall ms, host syncs, device launches and
            device ms (see run_batched_stage); checks all four PLYs, that the two
            poses differ, each image's batched DiT prediction against its batch-2
            one, and each image of a reduced run_batch against its own run.
9. pipeline the whole pipeline from one photo, as a user of the server runs it: POST
            /reconstruct of tools._scene.hoi_photo (1280x960, a hand holding a striped box)
            to serve.py's server, whose main.run_pipeline runs from its own env file in a
            temporary workspace, stages 1-9 in this process at full width
            (see run_pipeline_phase: each stage's build function hands over the models built
            here or by the earlier phases; FLUX.1-Kontext is built for stage 3 and freed
            after it; the field's level is set for stages 5 and 9 as in phases 5 and 6),
            with its own launch counts. Checks every artifact, the masks, both PLYs, all
            four kernels launched, no stage reporting an error, and that a second
            run_pipeline skips every stage (a wrapper of the server's run_pipeline does
            this before the server removes its workspace), then the response's two PLYs;
            prints s per image by stage (1-2, 3, 4, 5, 6, 7-8, 9) and of the whole, the
            server's own seconds around the run, and the peak memory.
10. result  the whole script's seconds, a `kernels` JSON line (`launches`: the
            guidance stage's run of one image; `launches_entry`, `launches_mesh`,
            `launches_convert`,
            `launches_hands`,
            `launches_stage_3`, `launches_stage_4`, `launches_stages_5_8`,
            `launches_batched`, `launches_pipeline`: entry()'s step, the mesh
            phase's ranks summed, the convert
            phase's CFG step of the loaded DiT, the multi-hand
            frame, the runs of stage 3, of stage 4, of stages 5-8, of the batched stage
            and of the pipeline through POST /reconstruct), the nvidia-smi line, and the
            `ok` JSON line.

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
import contextlib
import dataclasses
import gc
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
        ("dit_tp", 2, 8, 4442, 4442, 128),   # the DiT at tp=2 (a rank's heads), alone here
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


def _tile_inputs(camera, verts, faces, faces_per_tile, fov_deg=None):
    """The packed tile inputs (TileInputs) that rasterize() hands to the kernels,
    of one image (verts [V,3]) or of a batch (verts [B,V,3], fov_deg [B])."""
    from followmyhold_tpu_torch.ops.rasterizer import bin_and_pack

    mask = torch.ones((*verts.shape[:-2], faces.shape[-2]), device=verts.device)
    return bin_and_pack(camera, verts, faces, mask, 0.7, faces_per_tile, fov_deg=fov_deg)


def _raster_pairs(geom, tile_start, meta) -> tuple:
    """(all pairs, pairs within reach): every binned (pixel, face) pair of the
    lists, and those the kernels evaluate, inside the face's bounding box padded
    by the reach (non-degenerate faces only)."""
    counts = (tile_start[1:] - tile_start[:-1]).long()
    T = counts.numel()
    tile_of = torch.repeat_interleave(torch.arange(T, device=geom.device), counts)
    tile_of = tile_of % meta.tiles_per_image          # the tile within its image
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
    common = dict(faces=int(packed.tri[..., 0, 0].numel()), columns=int(geom.shape[1]),
                  longest_list=int(counts.max().item()), chunks=plan["chunks"],
                  pixel_face_pairs=pairs, pairs_after_cull=near)
    fwd = dict(common, ms=fwd_ms, graph_ms=fwd_t["graph_ms"], plain_ms=plain_fwd_ms,
               bound_ms=fwd_bound, bound_by=fwd_by, bound_ms_all_pairs=fwd_all, **cmp)
    bwd = dict(common, ms=bwd_ms, graph_ms=bwd_t["graph_ms"], plain_ms=plain_bwd_ms,
               bound_ms=bwd_bound, bound_by=bwd_by,
               bound_ms_all_pairs=bwd_all, max_abs_err=err_b, max_abs_ref=ref_max,
               loose_share=loose_b)
    say(f"kernel raster_fwd {tag} 512^2 F={common['faces']} P={geom.shape[1]} "
        f"T={tile_start.numel() - 1} (longest list "
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


def _check_raster_batch(R, camera, verts, faces, fovs, gen, faces_per_tile) -> tuple:
    """K3 and K4 (with the plan and the merge) on B images in one launch, as the
    batched phases render them: held against the plain version as at any shape
    (_check_raster_shape), and each image's slice of the outputs and of dgeom
    against that image's own launches, bit for bit (each tile's work and each
    dgeom column's one writer are the same; only the tile's index within its
    image places it)."""
    packed = _tile_inputs(camera, verts, faces, faces_per_tile, fov_deg=fovs)
    B, T = verts.shape[0], packed.meta.tiles_per_image
    tag = f"object x{B}"
    fwd, bwd, plan, got = _check_raster_shape(R, tag, packed, gen)
    grads = [torch.randn(got[0].shape, generator=gen, device=verts.device) for _ in range(3)]
    dgeom = R.raster_tiles_backward(packed.geom, packed.tile_start, got[2], got[3], *grads,
                                    packed.meta)
    torch.cuda.synchronize()
    for b in range(B):
        one = _tile_inputs(camera, verts[b], faces, faces_per_tile, fov_deg=fovs[b])
        rows = slice(b * T, (b + 1) * T)
        lo, hi = int(packed.tile_start[b * T]), int(packed.tile_start[(b + 1) * T])
        if not torch.equal(packed.geom[:, lo:hi], one.geom):
            fail(f"raster {tag}: image {b}'s packed geometry differs from its own binning")
        alone = R.raster_tiles_forward(one.geom, one.tile_start, one.meta)
        if not all(torch.equal(x[rows], y) for x, y in zip(got, alone)):
            fail(f"raster forward {tag}: image {b} differs from its own launch")
        d_one = R.raster_tiles_backward(one.geom, one.tile_start, alone[2], alone[3],
                                        *(g[rows] for g in grads), one.meta)
        torch.cuda.synchronize()
        if not torch.equal(dgeom[:, lo:hi], d_one):
            fail(f"raster backward {tag}: image {b}'s dgeom differs from its own launch")
    say(f"kernel raster {tag}: each image's w1, w2, slot, vis and dgeom columns equal its own "
        f"launch's bit for bit (bin_max {packed.bin_max} of {faces_per_tile})")
    for entry in (fwd, bwd):
        entry.update(images=B, bin_max=packed.bin_max, same_bits_as_each_image=True)
    return fwd, bwd


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
        plain = time_call(lambda: I.scatter_rows_add_plain(n_rows, index, src))
        lib = time_call(lambda: torch.zeros((n_rows, cols), device=dev).index_add_(0, index, src))
        longest = int(torch.bincount(index, minlength=n_rows).max().item())
        nbytes = index.numel() * (8.0 + 4.0 * cols) + n_rows * 4.0 * cols
        t_bytes, t_ops = nbytes / _HBM_BYTES * 1e3, index.numel() * cols / _F32_FLOPS * 1e3
        per_shape.append(dict(shape=label, rows=index.numel(), n_rows=n_rows, cols=cols,
                              longest_run=longest, max_abs_err=err, ms=t["eager_ms"],
                              graph_ms=t["graph_ms"], plain_ms=plain["eager_ms"],
                              library_ms=lib["eager_ms"], library_graph_ms=lib["graph_ms"],
                              bound_ms=max(t_bytes, t_ops),
                              bound_by="bytes" if t_bytes >= t_ops else "operations"))
        say(f"kernel scatter_rows_add {label} {index.numel()} rows -> {n_rows} x {cols} (longest "
            f"run {longest}): max |diff| to float64 {err:.3e}; same bits in two calls, no host "
            f"sync; kernel {t['eager_ms']:.4f} ms (graph replay {t['graph_ms']:.4f}), plain "
            f"(float64) {plain['eager_ms']:.4f} ms, atomic "
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


def rope_pair_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| of rotated q or k [..., D] in bf16 ulps of the length of each
    element's (even, odd) pair in ``want``. The rotation keeps a pair's length,
    so a normed value one ulp off (the kernel sums the squares in another order
    than PyTorch's reduction, which can move a rounding to bf16) comes out of it
    at most one ulp of that length off, while the rotated element itself may be
    much smaller than its pair."""
    g = got.float().reshape(*got.shape[:-1], -1, 2)
    w = want.float().reshape(*want.shape[:-1], -1, 2)
    length = torch.hypot(w[..., 0], w[..., 1])[..., None]
    # a bf16 value in [2^e, 2^(e+1)) has ulp 2^(e-7); 2^-133 is its least subnormal
    ulp = torch.exp2((torch.floor(torch.log2(length.clamp_min(2.0 ** -126))) - 7.0)
                     .clamp_min(-133.0))
    return ((g - w).abs() / ulp).reshape(got.shape)


# the share of q and k elements whose bits may differ from the plain version's:
# the sum of squares' order moves a bf16 rounding of the normed value now and
# then (41-44 of 15.7M elements at stage 3's shapes on an H100, 2.8e-6), while
# a norm computed in lower precision moves a large share of them
PROLOGUE_DIFFER_SHARE = 1e-5


def _prologue_faults(got, want) -> list:
    """What sets the kernel's q, k, v apart from the plain version's: q or k
    more than one pair-length ulp off anywhere, more than
    PROLOGUE_DIFFER_SHARE of their elements differing, or v not the same
    bits."""
    faults = [f"{name} {rope_pair_ulps(g, w).max().item():.3g} ulps"
              for name, g, w in zip("qk", got[:2], want[:2])
              if not rope_pair_ulps(g, w).max().item() <= 1.0]
    n_differ = sum(int((g != w).sum().item()) for g, w in zip(got[:2], want[:2]))
    n_qk = want[0].numel() + want[1].numel()
    if n_differ > PROLOGUE_DIFFER_SHARE * n_qk:
        faults.append(f"{n_differ} of {n_qk} q/k elements differ")
    if not torch.equal(got[2], want[2]):
        faults.append("v differs")
    return faults


def prologue_norm_lowered(streams, cos, sin, heads):
    """qk_norm_rope_plain with each norm's 1/rms rounded to bf16: a norm in
    lower precision than the plain version's, which the check must reject."""
    from followmyhold_tpu_torch.ops import rope as R

    def norm(x, weight):
        xf = R._heads(x, heads).float()
        r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + R.QK_NORM_EPS)
        return (xf * r.to(torch.bfloat16).float() * weight).to(x.dtype)

    q = torch.cat([norm(s[0], s[3]) for s in streams], dim=2)
    k = torch.cat([norm(s[1], s[4]) for s in streams], dim=2)
    v = torch.cat([R._heads(s[2], heads) for s in streams], dim=2)
    return R.apply_rope(q, cos, sin), R.apply_rope(k, cos, sin), v


def check_qk_norm_rope(dev) -> dict:
    """The FLUX blocks' attention prologue (csrc/qk_norm_rope.cu behind
    ops/rope.qk_norm_rope) at stage 3's shapes: a single block's stream
    [1,2560,3072] into [1,24,2560,128], and a double block's two streams, 512
    text rows at offset 0 and 2,048 image rows at offset 512, into one joint
    buffer; cos/sin from a 512^2 crop's ids (the T5 rows at 0, the noisy and the
    context latents). Held against qk_norm_rope_plain on the same inputs: q and k
    within one bf16 ulp of their pair's length (rope_pair_ulps) and at most
    PROLOGUE_DIFFER_SHARE of them differing, v the same bits; the same bits in
    two calls; the checked call follows a call on other inputs whose freed
    buffers the allocator hands to it; no host sync. Three mutants must fail
    that check: the image rows written at offset 511, the plain output with
    one pair's rotation sign flipped, and the plain output with the norm's
    1/rms rounded to bf16 (prologue_norm_lowered). Timed eager and as
    a CUDA-graph replay, beside the plain version (with the copy of v the
    attention made of a single block's view) and the byte bound."""
    from followmyhold_tpu_torch.models import flux as F
    from followmyhold_tpu_torch.ops import _kernels
    from followmyhold_tpu_torch.ops import rope as R
    from followmyhold_tpu_torch.tools.time_raster_kernels import time_call

    H, D, n_txt, n_img = 24, 128, 512, 2048
    n_joint = n_txt + n_img
    ids = torch.cat([torch.zeros(n_txt, 3), torch.from_numpy(F.latent_ids(32, 32, 0)),
                     torch.from_numpy(F.latent_ids(32, 32, 1))]).to(dev)
    cos, sin = F.rope_freqs(ids, F.FLUX_DEV.axes_dims_rope)
    gen = torch.Generator(device=dev).manual_seed(20)

    def stream(n):
        qkv = [torch.randn((1, n, H * D), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3)]
        norms = [1.0 + 0.1 * torch.randn(D, generator=gen, device=dev) for _ in range(2)]
        return (*qkv, *norms)

    cases = [("single", [stream(n_joint)]), ("double", [stream(n_txt), stream(n_img)])]
    per_case = []
    for label, streams in cases:
        negated = [tuple(-x for x in s) for s in streams]
        other = R.qk_norm_rope_forward(negated, cos, sin, H)
        del other
        torch.cuda.synchronize()
        before = _kernels.launch_counts()["qk_norm_rope"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = R.qk_norm_rope_forward(streams, cos, sin, H)
            again = R.qk_norm_rope_forward(streams, cos, sin, H)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launches = (_kernels.launch_counts()["qk_norm_rope"] - before) // 2
        if launches != len(streams):
            fail(f"qk_norm_rope {label}: {launches} launches a call for {len(streams)} streams")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"qk_norm_rope {label}: two calls on the same inputs differ")
        want = R.qk_norm_rope_plain(streams, cos, sin, H)
        faults = _prologue_faults(got, want)
        if faults:
            fail(f"qk_norm_rope {label}: differs from the plain version: {faults}")
        ulps = [rope_pair_ulps(g, w).max().item() for g, w in zip(got[:2], want[:2])]
        n_differ = sum(int((g != w).sum().item()) for g, w in zip(got[:2], want[:2]))

        # the mutants the check must reject
        if label == "double":
            shifted = tuple(torch.zeros_like(x) for x in got)
            R.qk_norm_rope_into(streams[0], cos, sin, H, shifted, 0)
            R.qk_norm_rope_into(streams[1], cos, sin, H, shifted, n_txt - 1)
            if not _prologue_faults(shifted, want):
                fail("qk_norm_rope: the image rows at offset n_txt - 1 pass the check")
        flipped_sin = sin.clone()
        flipped_sin[:, 5] = -flipped_sin[:, 5]
        flipped = R.qk_norm_rope_plain(streams, cos, flipped_sin, H)
        if not _prologue_faults(flipped, want):
            fail(f"qk_norm_rope {label}: one pair's rotation sign flipped passes the check")
        if not _prologue_faults(prologue_norm_lowered(streams, cos, sin, H), want):
            fail(f"qk_norm_rope {label}: the norm's 1/rms in bf16 passes the check")

        t = time_call(lambda: R.qk_norm_rope_forward(streams, cos, sin, H))
        plain = time_call(lambda: [x.contiguous()
                                   for x in R.qk_norm_rope_plain(streams, cos, sin, H)])
        n_elems = n_joint * H * D
        nbytes = (2 * 3 * n_elems * 2               # q, k, v read and written, bf16
                  + 2 * n_joint * (D // 2) * 4      # the cos and sin rows
                  + len(streams) * 2 * D * 4)       # the norm scales
        bound = nbytes / _HBM_BYTES * 1e3
        per_case.append(dict(shape=label, tokens=n_joint, streams=len(streams),
                             max_pair_ulps=max(ulps), qk_elements_differing=n_differ,
                             ms=t["eager_ms"], graph_ms=t["graph_ms"],
                             plain_ms=plain["eager_ms"], plain_graph_ms=plain["graph_ms"],
                             bound_ms=bound, bound_by="bytes",
                             pct_of_bound=100.0 * bound / t["graph_ms"],
                             launches_per_call=launches))
        say(f"kernel qk_norm_rope {label} ({len(streams)} stream(s), {n_joint} joint rows of "
            f"{H}x{D}): q/k within {max(ulps):.3g} bf16 ulps of their pair's length, "
            f"{n_differ} of their {2 * n_elems} elements differing (at most "
            f"{PROLOGUE_DIFFER_SHARE:g} of them), v the same bits; same bits in "
            f"two calls, no host sync; the three mutants rejected; kernel {t['eager_ms']:.4f} ms "
            f"(graph replay {t['graph_ms']:.4f}), plain {plain['eager_ms']:.4f} ms (graph "
            f"replay {plain['graph_ms']:.4f}); bound {bound:.4f} ms (bytes: {nbytes / 1e6:.1f} "
            f"MB), {100.0 * bound / t['graph_ms']:.1f} % of it; {launches} launch(es) a call")
    head = per_case[0]
    return dict(name="qk_norm_rope", route="cuda", graph_ms=head["graph_ms"],
                source="followmyhold_tpu_torch/csrc/qk_norm_rope.cu",
                replaces=None,
                replaces_note="no Pallas kernel: XLA fuses the reference's QK norm, RoPE and "
                              "joint concatenation (followmyhold_tpu/models/flux.py)",
                max_pair_ulps=max(x["max_pair_ulps"] for x in per_case), ms=head["ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], shapes=per_case)


def attach_raster_overlays(kernels: list, overlays, multi_hand_overlays) -> None:
    """Put the (raster_fwd, raster_bwd) measurements of stages 5-8's overlay
    mesh and of the multi-hand frame's on the kernels of those names."""
    by_name = {k["name"]: k for k in kernels}
    for name, overlay, multi in zip(("raster_fwd", "raster_bwd"), overlays,
                                    multi_hand_overlays, strict=True):
        by_name[name]["overlay_mesh"] = overlay
        by_name[name]["multi_hand_overlay_mesh"] = multi


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
    # the batched phases' render: the object in two images (the batched stage's two
    # fields of view, the second image's sphere moved) in one launch
    obj_b = torch.stack([obj_verts, obj_verts + torch.tensor([0.03, -0.02, 0.05], device=dev)])
    fovs = torch.tensor(BATCH_FOVS, device=dev)
    fwd_b, bwd_b = _check_raster_batch(R, camera, obj_b, sphere.faces[:nf], fovs, gen, 24576)
    bin_ms_b = cuda_ms(lambda: _tile_inputs(camera, obj_b, sphere.faces[:nf], 24576, fovs), 1, 5)
    fwd_b["bin_and_pack_ms"] = bin_ms_b
    say(f"raster object x2 512^2: projecting, binning and packing both (torch ops) "
        f"{bin_ms_b:.3f} ms")
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
                                    extra.get("moge_mesh", {}).get("max_abs_err", 0.0),
                                    extra.get("object_mesh_batched", {}).get("max_abs_err", 0.0)),
                    ms=hand["ms"],
                    graph_ms=hand["graph_ms"], plain_ms=hand["plain_ms"],
                    bound_ms=hand["bound_ms"], bound_by=hand["bound_by"], library_ms=None,
                    chunk=R.RASTER_CHUNK, hand_mesh=hand, object_mesh=obj, **extra)

    fwd = entry("raster_fwd", "raster_fwd.cu", 506, fwd_h, fwd_o, moge_mesh=fwd_m,
                object_mesh_batched=fwd_b,
                pixel_face_pairs=fwd_h["pixel_face_pairs"],
                pairs_after_cull=fwd_h["pairs_after_cull"],
                bound_ms_all_pairs=fwd_h["bound_ms_all_pairs"],
                slot_mismatch=max(fwd_h["slot_mismatch"], fwd_o["slot_mismatch"],
                                  fwd_m["slot_mismatch"]))
    bwd = entry("raster_bwd", "raster_bwd.cu", 530, bwd_h, bwd_o, moge_mesh=bwd_m,
                object_mesh_batched=bwd_b,
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
    c = vae.cfg
    per = 2 * c.fourier_freqs + 1
    keep = torch.zeros(3 * per, dtype=torch.bool, device=dev)
    keep[[a * per + j for a in range(3) for j in (0, 1, 1 + c.fourier_freqs)]] = True
    with torch.no_grad():
        vae.geo.query_in.weight[:, ~keep] = 0.0
        vae.geo.proj.weight.mul_(_ATTENTION_SCALE)
        vae.geo.proj.bias.mul_(_ATTENTION_SCALE)
    level, spread = _guidance_level(dev, dit, vae, cond_main, uncond_main, IMAGE_ID)
    with torch.no_grad():
        vae.geo.logit.bias -= level
    return dict(logit_shift=-level, spread=spread)


def _guidance_level(dev, dit, vae, cond_main, uncond_main, image_id: str) -> tuple:
    """The logit level that puts _INSIDE_SHARE of the box inside at the
    latents of an unguided 20-step run at 5.0 from the guidance stage's noise
    for image_id and the given condition. -> (level, the logits' spread)."""
    from followmyhold_tpu_torch.diffusion.pipeline import denoise_latents
    from followmyhold_tpu_torch.utils.prng import SEED_GUIDANCE, stage_generator

    shape = (1, vae.cfg.num_latents, vae.cfg.embed_dim)
    noise = torch.randn(shape, generator=stage_generator(SEED_GUIDANCE, "guidance", image_id, dev),
                        device=dev)
    lat = denoise_latents(dit, cond_main, uncond_main, shape[1:], num_inference_steps=20,
                          guidance_scale=5.0, initial_noise=noise, device=dev)
    g = _box_logits(dev, vae, lat)
    return torch.quantile(g, 1.0 - _INSIDE_SHARE).item(), (g.max() - g.min()).item()


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


def _stage5_level(dev, models, crops, tag: str = "hoi") -> dict:
    """The logit level that puts _INSIDE_SHARE of the box inside at the
    latents stage 5 reaches for crops, (image id, crop without background)
    pairs (30 CFG steps at 7.5 from the stage's
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
    for image_id, path in crops:
        rgb = np.asarray(Image.open(path).convert("RGB"))
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
    say(f"{tag}: stage 5's field level {level:.4f} (the guidance-shaped field's logits over the "
        f"box span {g.min().item():.4f} to {g.max().item():.4f}); inside shares then "
        f"{[round(x, 4) for x in shares]}")
    if min(shares) <= 0.0:
        fail(f"stage 5's field has no surface for one of {[c[0] for c in crops]}: inside "
             f"shares {shares}")
    return dict(level=level, inside_shares=shares)


# stage 3's full-width transformer forward with K1 against the same forward with the
# plain attention: measured 1.25e-2 relative (one H100 80GB HBM3 at 700 W: 57 blocks of
# bf16 attention, K1's per-call 2.9e-3 compounding through the residual stream); the
# limit is twice that
_FLUX_REL_LIMIT = 2.5e-2
_INPAINT_PROMPT = "Remove hands but keep the object."


# stage 2's photos on the learned path: the first pays the models' first calls
DETECT_IDS = ("000004", "000005")


def _event_spans(record: dict, key: str, fn):
    """fn, with a pair of CUDA events recorded around each call into record[key]
    (read after the run, so no host synchronisation is added)."""
    def wrapped(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        record.setdefault(key, []).append((start, end))
        return out
    return wrapped


def _read_outputs(key: str, out) -> dict:
    """A learned model's outputs (a tensor, tuple or dict) that the detect phase
    reads, by name, each with whether it may hold -inf. GroundingDINO's logits
    may be -inf (the text's padding) and its encoder's coordinate logits +inf
    (the proposals it rules out), by design, so its boxes, logits and encoder
    features are read."""
    if key == "gdino":
        return {n: (out[n], n == "logits")
                for n in ("logits", "pred_boxes", "encoder_text", "encoder_vision")}
    tensors = {"": out} if isinstance(out, torch.Tensor) else (
        out if isinstance(out, dict) else dict(enumerate(out)))
    return {n: (t, False) for n, t in tensors.items()}


def _outputs_finite(key: str, out) -> bool:
    """A learned model's outputs finite (-inf where _read_outputs allows it)."""
    return all(bool((torch.isfinite(t) | (neg_inf & (t == -float("inf")))).all())
               for t, neg_inf in _read_outputs(key, out).values())


def _largest_output(key: str, out) -> float:
    """The largest |entry| of the finite entries of a learned model's outputs."""
    return max((float(t[torch.isfinite(t)].abs().max().float())
                for t, _ in _read_outputs(key, out).values() if torch.isfinite(t).any()),
               default=0.0)


def _bits(value) -> list:
    """The bytes of a bundle function's result (arrays, numbers, detections,
    None), for a same-bits comparison."""
    if value is None:
        return [b"None"]
    if isinstance(value, (list, tuple)):
        return [b for v in value for b in _bits(v)]
    if hasattr(value, "box_xyxy"):
        return _bits((value.box_xyxy, value.score, value.is_right))
    a = np.asarray(value)
    return [str(a.dtype).encode(), str(a.shape).encode(), a.tobytes()]


# the logit GroundingDINO's best query is lifted to on random weights: sigmoid(2) = 0.88
_GDINO_BEST_LOGIT = 2.0


def _shape_gdino(out: dict, raw_best: list) -> dict:
    """GroundingDINO's outputs with its logits shifted so that the best query's
    is _GDINO_BEST_LOGIT (the -inf of the text's padding stays): on random
    weights every query scores under detect_text_prompt's 0.3 (the raw best is
    appended to raw_best), no box would reach SAM2, and stage 2 would not run
    its segmenter. The shift keeps the queries' order; nothing else changes."""
    logits = out["logits"]
    best = torch.where(torch.isfinite(logits), logits, -float("inf")).amax()
    raw_best.append(best)
    out["logits"] = logits - best + _GDINO_BEST_LOGIT
    return out


# the persons of the hands phase's frame
HANDS_PERSONS = 2


def _shape_gdino_persons(out: dict, raw_scores: list, n: int = HANDS_PERSONS) -> dict:
    """GroundingDINO's outputs with its logits shifted so that exactly its ``n``
    best queries pass the person detector's 0.5: the shift puts 0 halfway between
    the n-th and the (n+1)-th query's best token logit (the raw ones of the best
    n + 1 are appended to raw_scores). On random weights no query passes, and lifted
    as _shape_gdino lifts them (the best to sigmoid(2)) nearly all of the 900 queries
    pass together, each a person box to run ViTPose on. The shift keeps the queries'
    order and the boxes; nothing else changes."""
    logits = out["logits"]
    per_query = torch.where(torch.isfinite(logits), logits, -float("inf")).amax(-1)
    top = per_query.flatten().topk(n + 1).values
    raw_scores.append(top)
    out["logits"] = logits - (top[n - 1] + top[n]) / 2
    return out


def run_detect_phase(dev) -> dict:
    """Stage 2 on its learned path, as a user runs it where the four converted
    detector files exist: preprocess/get_hunyuan_input.run on a split of two photos
    (tools._scene.hoi_photo, 1280x960, seeds 0 and 1; the first pays the models'
    first calls) with preprocess.detectors.LearnedBundle built here at the published
    widths and full depth (YOLOv8-n, the ResNet-101 Faster R-CNN, GroundingDINO with
    Swin-B and BERT-base, SAM2 Hiera-L; seeded random weights) and handed over as the
    pipeline phase hands over its models, with a synthetic WordPiece vocabulary so the
    prompts take the checkpoint's tokenizer path; GroundingDINO's logits are lifted so
    that its best query passes the threshold (_shape_gdino: on random weights none does,
    and SAM2 would not run). A photo: YOLO at 640^2 (8,400 anchors), the Faster R-CNN at
    800x600 (a 50x38 map, 22,800 anchors, 6,000 to NMS, at most 300 rois), then, on the
    crop, GroundingDINO at 800^2 and SAM2 at 1024^2 for the object and for "only hand".
    Checks the five directories' files, every model output finite (GroundingDINO's
    logits may be -inf at the text's padding), each crop's union box inside its photo,
    both masks of the crop's shape, each model run as often as the stage runs it, and
    two calls of each bundle function giving the same bits (boxes, scores, masks).
    Prints the build time and parameter count of each model, s per image and by part
    for each photo (the card's parts on CUDA events, no host synchronisation added; the
    host's PIL resizes on its clock), the candidates before and after each NMS, the
    host synchronisations of each bundle call, the largest finite |output| of each model
    (the seeded init's scale at full depth) and the peak memory. The bundle is returned
    for the hands and serve phases (its GroundingDINO finds the persons, and /segment
    runs it), which free it before stage 3."""
    import gc
    import tempfile

    import PIL.Image
    from PIL import Image

    from followmyhold_tpu_torch.configs.profiles import crop_size
    from followmyhold_tpu_torch.models import hand_object_detector as hod
    from followmyhold_tpu_torch.ops import nms as nms_ops
    from followmyhold_tpu_torch.preprocess import detectors
    from followmyhold_tpu_torch.preprocess import get_hunyuan_input as stage2
    from followmyhold_tpu_torch.preprocess import segment_hoi
    from followmyhold_tpu_torch.tools._scene import hoi_photo, write_gdino_vocab

    root = tempfile.mkdtemp(prefix="fmh_detect_")
    before_assets = os.environ.get("FOHO_TPU_ASSETS")
    os.environ["FOHO_TPU_ASSETS"] = os.path.join(root, "assets")
    write_gdino_vocab(os.path.join(root, "assets"))
    photos = [hoi_photo(seed=k) for k in range(len(DETECT_IDS))]
    H, W = photos[0].shape[:2]
    split = os.path.join(root, "split.csv")
    with open(split, "w", encoding="utf-8") as f:
        f.write("img_id,img_path\n")
        for image_id, photo in zip(DETECT_IDS, photos):
            Image.fromarray(photo).save(os.path.join(root, f"{image_id}.png"))
            f.write(f"{image_id},{os.path.join(root, image_id)}.png\n")

    built = {}
    load_or_init = detectors.load_or_init

    def timed_build(name, module, init):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = load_or_init(name, module, init)
        torch.cuda.synchronize()
        built[name] = (time.perf_counter() - t,
                       sum(p.numel() for p in module.parameters()) / 1e6)
        return out

    detectors.load_or_init = timed_build
    try:
        t0 = time.perf_counter()
        bundle = detectors.LearnedBundle(device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        detectors.load_or_init = load_or_init
    say(f"detect: built the learned bundle at full width in {build_s:.2f} s ("
        + ", ".join(f"{n} {t:.2f} s, {m:.2f} M parameters" for n, (t, m) in built.items())
        + f"; {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card)")

    spans, nms_calls, outputs, unions, raw_best = {}, [], {}, [], []
    image_s, pil_s = [], [0.0]
    resize, process_bbox, hoi_detector = (PIL.Image.Image.resize, segment_hoi.process_bbox,
                                          stage2.hoi_detector)

    def counted_nms(key, fn):
        def wrapped(boxes, scores, *a, **k):
            keep = fn(boxes, scores, *a, **k)
            nms_calls.append((key, boxes.shape[0], keep))
            return keep
        return _event_spans(spans, f"{key} nms", wrapped)

    def timed_resize(self, *a, **k):
        t = time.perf_counter()
        out = resize(self, *a, **k)
        pil_s[-1] += time.perf_counter() - t
        return out

    def union_box(xywh, *a, **k):
        unions.append([float(v) for v in xywh])
        return process_bbox(xywh, *a, **k)

    def timed_detector(*a, **k):             # one photo: s on the host's clock, its PIL share
        pil_s.append(0.0)
        t = time.perf_counter()
        out = hoi_detector(*a, **k)
        image_s.append(time.perf_counter() - t)
        return out

    models = {"yolo": bundle.yolo, "frcnn": bundle.frcnn, "gdino": bundle.gdino,
              "sam2": bundle.sam}
    shaping = bundle.gdino.register_forward_hook(
        lambda mod, args, out: _shape_gdino(out, raw_best))
    hooks = [m.register_forward_hook(
        lambda mod, args, out, key=key: outputs.setdefault(key, []).append(out))
        for key, m in models.items()]
    for key, m in models.items():
        m.forward = _event_spans(spans, key, m.forward)
    bundle.frcnn.trunk = _event_spans(spans, "frcnn trunk", bundle.frcnn.trunk)
    bundle.frcnn.proposals = _event_spans(spans, "frcnn rpn", bundle.frcnn.proposals)
    originals = [(stage2, "default_bundle", stage2.default_bundle),
                 (stage2, "hoi_detector", hoi_detector),
                 (nms_ops, "nms", nms_ops.nms), (hod, "nms", hod.nms),
                 (hod, "roi_align", hod.roi_align), (PIL.Image.Image, "resize", resize),
                 (segment_hoi, "process_bbox", process_bbox)]
    dirs = [os.path.join(root, d) for d in ("occ", "crops", "crops_wo_bg", "masks", "orig")]
    tee = _Tee(sys.stdout)
    try:
        nms_ops.nms = counted_nms("yolo", nms_ops.nms)
        hod.nms = counted_nms("frcnn", hod.nms)
        hod.roi_align = _event_spans(spans, "frcnn roi_align", hod.roi_align)
        stage2.default_bundle = lambda device="cuda": bundle
        stage2.hoi_detector = timed_detector
        segment_hoi.process_bbox = union_box
        PIL.Image.Image.resize = timed_resize
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            stage2.run(*dirs, split_path=split, device=dev)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
        for h in hooks:
            h.remove()
        for m in models.values():
            m.__dict__.pop("forward", None)
        bundle.frcnn.__dict__.pop("trunk", None)
        bundle.frcnn.__dict__.pop("proposals", None)
    said = "".join(tee.parts)

    # ---- checks ---------------------------------------------------------- #
    n = len(DETECT_IDS)
    if "Error" in said or said.count("Processed ") != n:
        fail(f"stage 2 on the learned path reported: {said!r}")
    occ, crops, crops_wo_bg, masks, orig = dirs
    files, shares = {}, {}
    for image_id in DETECT_IDS:
        rid = 0 if os.path.exists(os.path.join(crops, f"{image_id}_cropped_hoi_0.png")) else 1
        files[image_id] = [
            os.path.join(orig, f"{image_id}.png"),
            os.path.join(occ, f"{image_id}_masked_obj.png"),
            os.path.join(crops, f"{image_id}_cropped_hoi_{rid}.png"),
            os.path.join(crops_wo_bg, f"{image_id}_cropped_hoi_{rid}.png"),
            os.path.join(masks, f"{image_id}_cropped_obj_mask.png"),
            os.path.join(masks, f"{image_id}_cropped_hand_mask.png"),
            os.path.join(masks, f"{image_id}_crop_transform.npy")]
        missing = [os.path.relpath(f, root) for f in files[image_id] if not os.path.exists(f)]
        if missing:
            fail(f"stage 2 on the learned path wrote no {missing}")
        for name in ("obj", "hand"):
            m = np.asarray(Image.open(os.path.join(masks, f"{image_id}_cropped_{name}_mask.png")))
            if m.shape != (crop_size(),) * 2:
                fail(f"the {name} mask is {m.shape}, not the crop's {(crop_size(),) * 2}")
            shares[f"{image_id} {name}"] = round(float((m > 0).mean()), 4)
    calls = {k: len(v) for k, v in outputs.items()}
    if calls != {"yolo": n, "frcnn": n, "gdino": 2 * n, "sam2": 2 * n}:
        fail(f"stage 2 ran the models {calls} times on {n} photos, not YOLO and the Faster "
             f"R-CNN once a photo and GroundingDINO and SAM2 twice")
    bad = [k for k, outs in outputs.items() for out in outs if not _outputs_finite(k, out)]
    if bad:
        fail(f"the learned models gave non-finite outputs: {bad}")
    largest = {k: max(_largest_output(k, out) for out in outs) for k, outs in outputs.items()}
    for x, y, w, h in unions:
        if not (0 <= x and 0 <= y and x + w <= W - 1 and y + h <= H - 1):
            fail(f"a crop's union box {[x, y, w, h]} is not inside the {W}x{H} photo")

    # two calls of each bundle function: the same bits; their host synchronisations
    crop = np.asarray(Image.open(files[DETECT_IDS[0]][2]).convert("RGB"))
    syncs, same = {}, {}
    for name, fn in (("detect_hands", lambda: bundle.detect_hands(photos[0])),
                     ("detect_hand_object", lambda: bundle.detect_hand_object(photos[0])),
                     ("segment(object)", lambda: bundle.segment(crop, "object")),
                     ("segment(only hand)", lambda: bundle.segment(crop, "only hand"))):
        got = []
        syncs[name] = _count_syncs(lambda: got.append(fn()))
        got.append(fn())
        same[name] = _bits(got[0]) == _bits(got[1])
    if not all(same.values()):
        fail(f"two calls of the learned bundle gave other bits: {same}")
    if before_assets is None:
        os.environ.pop("FOHO_TPU_ASSETS", None)
    else:
        os.environ["FOHO_TPU_ASSETS"] = before_assets

    torch.cuda.synchronize()
    ms = {k: [s.elapsed_time(e) / 1e3 for s, e in v] for k, v in spans.items()}
    parts = []
    for i in range(n):
        p = {k: ms[k][i] for k in ("yolo", "yolo nms", "frcnn", "frcnn trunk", "frcnn rpn",
                                   "frcnn nms", "frcnn roi_align")}
        p["frcnn layer4 and heads"] = p["frcnn"] - sum(p[k] for k in (
            "frcnn trunk", "frcnn rpn", "frcnn nms", "frcnn roi_align"))
        p["gdino"] = ms["gdino"][2 * i:2 * i + 2]
        p["sam2"] = ms["sam2"][2 * i:2 * i + 2]
        p["host PIL resizes"] = pil_s[i + 1]
        parts.append(p)
        say(f"detect: photo {DETECT_IDS[i]} ({'first' if i == 0 else 'warm'}): "
            f"{image_s[i]:.3f} s in hoi_detector; by part (s): "
            + ", ".join(f"{k} {[round(x, 4) for x in v] if isinstance(v, list) else round(v, 4)}"
                        for k, v in p.items()))
    counts = [(key, n_in, int(keep.sum())) for key, n_in, keep in nms_calls]
    n_anchors = sorted({k[0] * k[1] * 12 for k in bundle.frcnn._anchors})
    say(f"detect: stage 2 on the learned path {stage_s:.3f} s for {n} photos "
        f"({stage_s / n:.3f} s an image, files included); NMS candidates (model, in, kept): "
        f"{counts}, of 8,400 YOLO and {n_anchors} Faster R-CNN anchors; union boxes "
        f"{[[round(v, 1) for v in u] for u in unions]} in {W}x{H}; mask shares {shares}; "
        f"GroundingDINO's best raw logit a call {[round(float(b), 3) for b in raw_best[:2 * n]]} "
        f"(shifted to {_GDINO_BEST_LOGIT}); largest finite |output| per model (seeded init, "
        f"convs N(0, 1/in_channels)) {{{', '.join(f'{k}: {v:.4g}' for k, v in largest.items())}}}; "
        f"peak {peak_gib:.2f} GiB")
    say(f"detect: host synchronisations per bundle call {syncs}; two calls give the same "
        f"bits {same}")
    shaping.remove()
    del models, outputs, spans, nms_calls
    gc.collect()
    shutil.rmtree(root, ignore_errors=True)
    return dict(seconds=stage_s, image_s=image_s, parts=parts, nms=counts, syncs=syncs,
                peak_gib=peak_gib, built=built, largest=largest, bundle=bundle)


# the raw frame of the hands phase (two people side by side)
HANDS_ID = "000006"
# how far over the threshold the shaping puts the 4th most confident keypoint of
# each hand block (a block needs more than 3 keypoints over 0.5)
_VITPOSE_MARGIN = 0.05


def _hand_block_confidences(kps: np.ndarray) -> list:
    """The confidences of each hand block of wholebody keypoints, best first."""
    from followmyhold_tpu_torch.models.vitpose import LEFT_HAND_SLICE, RIGHT_HAND_SLICE

    return [np.sort(kps[sl, 2])[::-1] for sl in (LEFT_HAND_SLICE, RIGHT_HAND_SLICE)]


def run_hands_phase(dev, bundle) -> dict:
    """The hand stage's multi-hand chain on a raw frame, as a user runs it with
    --multi_hand: hand/hamer.run(multi_hand=True, save_overlay=True) on
    tools._scene.two_person_frame (1280x960, two people side by side), handed
    ViTPose-H wholebody (models/vitpose.py: ViT-H, 1280 wide, 32 deep, two 256-channel
    transposed convolutions, 133 heatmaps; bf16, seeded random weights, built on the
    card), the detect phase's resident GroundingDINO as the GdinoPersonDetector
    ("person." at 0.5) and HaMeR ViT-H. Random weights score no GroundingDINO query
    over 0.5, so its logits are shifted until its two best queries pass, one box for
    each person of the frame (_shape_gdino_persons); random
    heatmaps may give a hand block 3 or fewer keypoints over 0.5, so each block's raw
    count is printed and, where a block falls short, the final bias of the 42 hand
    keypoints alone is raised until every block of every crop has 4 (the heatmaps'
    argmaxes, the keypoints' positions, do not move). Its own launch counts. Checks: two
    or more hands stacked in {id}.npy, one {id}_hamer_{k}.obj each, every output
    finite, the overlay written and its render through K3 held against the plain
    version, two calls of the ViTPose forward giving the same bits. Then the pipeline
    mode's box where a ViTPose file exists: hand/hamer.run on the two HOI crops of
    stages 4-8 (write_stage_inputs) with the same front end handed over must centre
    each box on the crop side's keypoint block, not on the hand mask. Prints s per
    frame by part (person boxes, the ViTPose forwards, the HaMeR forward per hand,
    the overlay), the host synchronisations of one VitPoseFrontEnd.keypoints call and
    the peak memory. The ViTPose and HaMeR models are freed after it."""
    import tempfile

    from PIL import Image

    from followmyhold_tpu_torch.hand import hamer as hand
    from followmyhold_tpu_torch.models.vitpose import build_vitpose
    from followmyhold_tpu_torch.ops import _kernels
    from followmyhold_tpu_torch.ops import rasterizer as R
    from followmyhold_tpu_torch.tools._scene import two_person_frame, write_stage_inputs
    from followmyhold_tpu_torch.utils.mesh_io import load_mesh

    root = tempfile.mkdtemp(prefix="fmh_hands_")
    frame_dir, out_dir = os.path.join(root, "frames"), os.path.join(root, "hands")
    os.makedirs(frame_dir)
    frame = two_person_frame()
    Image.fromarray(frame).save(os.path.join(frame_dir, f"{HANDS_ID}.png"))
    img01 = frame.astype(np.float32) / 255.0
    d = write_stage_inputs(os.path.join(root, "crops"), size=512, moge_grid=(8, 8),
                           hoi_ids=HOI_IDS)
    hoi_crops = [np.asarray(Image.open(os.path.join(
        d["cropped_hoi_dir"], f"{image_id}_cropped_hoi_{k % 2}.png")).convert("RGB"),
        np.float32) / 255.0 for k, image_id in enumerate(HOI_IDS)]

    t0 = time.perf_counter()
    vitpose = build_vitpose(seed=0, device=dev)
    hamer_model = hand._build_model(hand._default_config(), device=dev)
    torch.cuda.synchronize()
    n_pose = sum(p.numel() for p in vitpose.parameters()) / 1e9
    say(f"hands: built ViTPose-H ({n_pose:.3f} billion parameters, bf16) and HaMeR at full "
        f"width in {time.perf_counter() - t0:.1f} s")
    front = hand.VitPoseFrontEnd(model=vitpose)
    persons = hand.GdinoPersonDetector(model=bundle.gdino)
    raw_scores = []
    shaping = bundle.gdino.register_forward_hook(
        lambda mod, args, out: _shape_gdino_persons(out, raw_scores))

    # shaping ViTPose: each hand block's raw count of confident keypoints on every
    # crop this phase gives it, and the hand keypoints' bias raised where one falls short
    boxes = persons.person_boxes(img01)
    crops = [crop for _, crop in hand.person_crops(img01, boxes)] + hoi_crops
    blocks = [b for crop in crops for b in _hand_block_confidences(front.keypoints(crop))]
    raw_counts = [int((b > 0.5).sum()) for b in blocks]
    shift = max(0.0, max(0.5 - b[3] + _VITPOSE_MARGIN for b in blocks))
    with torch.no_grad():
        vitpose.final.bias[91:133] += shift
    say(f"hands: {len(boxes)} person boxes over 0.5 (GroundingDINO's logits shifted so that "
        f"its {HANDS_PERSONS} best queries pass; the raw best {HANDS_PERSONS + 1} "
        f"{[round(float(b), 3) for b in raw_scores[0]]}): "
        f"{[[round(float(v), 1) for v in b] for b in boxes]}, {len(crops) - len(hoi_crops)} "
        f"crops of 16 px or more; confident keypoints (> 0.5) per hand block before the shaping, "
        f"(left, right) per crop: {list(zip(raw_counts[0::2], raw_counts[1::2]))}; the hand "
        f"keypoints' final bias raised by {shift:.4f}")

    calls = {}
    patched = [(hand, "_process_hand", "hamer"), (hand, "render_overlay", "overlay"),
               (front, "keypoints", "vitpose"), (persons, "person_boxes", "person boxes")]
    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in patched]
    tee = _Tee(sys.stdout)
    try:
        for (owner, name, key), (_, _, fn) in zip(patched, originals):
            setattr(owner, name, _timed(fn, calls, key))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            hand.run(frame_dir, out_dir, multi_hand=True, save_overlay=True, model=hamer_model,
                     pose_front=front, person_detector=persons, device=dev)
        torch.cuda.synchronize()
        frame_s = time.perf_counter() - t0
        launches = _kernels.launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        for owner, name, fn in originals:
            if owner in (front, persons):
                owner.__dict__.pop(name, None)
            else:
                setattr(owner, name, fn)
    said = "".join(tee.parts)

    # ---- checks ---------------------------------------------------------- #
    res = np.load(os.path.join(out_dir, f"{HANDS_ID}.npy"), allow_pickle=True).item()
    kps = np.load(os.path.join(out_dir, f"{HANDS_ID}_kps_for_guidance.npy"),
                  allow_pickle=True).item()
    n_hands = res["pred_vertices"].shape[0]
    if n_hands < 2 or f"({n_hands} hand(s))" not in said:
        fail(f"the multi-hand run stacked {n_hands} hands: {said!r}")
    if not all(np.isfinite(np.asarray(v, np.float64)).all()
               for v in (*res.values(), *kps.values())):
        fail("the multi-hand run's arrays are not finite")
    for k in range(n_hands):
        obj = load_mesh(os.path.join(out_dir, f"{HANDS_ID}_hamer_{k}.obj"))
        if not (obj.num_vertices == 778 and np.isfinite(obj.vertices).all()):
            fail(f"{HANDS_ID}_hamer_{k}.obj has {obj.num_vertices} vertices or is not finite")
    if not os.path.exists(os.path.join(out_dir, f"{HANDS_ID}_overlay.png")):
        fail(f"the multi-hand run wrote no overlay: {said!r}")
    if launches["raster_fwd"] < 1 or launches["raster_chunk_plan"] < 1:
        fail(f"the multi-hand overlay did not launch K3: {launches}")

    # K3 against its plain version on the overlay's render of every hand
    cfg = hamer_model.cfg
    faces = np.asarray(load_mesh(os.path.join(out_dir, f"{HANDS_ID}_hamer_0.obj")).faces)
    hands = [{"pred_vertices": res["pred_vertices"][k],
              "pred_cam_t_full": res["pred_cam_t_full"][k]} for k in range(n_hands)]
    H, W = frame.shape[:2]
    camera, verts, fcs, _ = hand.overlay_scene(hands, faces, (H, W),
                                               cfg.focal_length / cfg.image_size * max(H, W), dev)
    packed = _tile_inputs(camera, verts, fcs, hand.overlay_faces_per_tile(fcs.shape[0]))
    fwd_ov, bwd_ov, _, got = _check_raster_shape(R, "multi-hand overlay", packed,
                                                 torch.Generator(device=dev).manual_seed(17))
    covered = int((got[2] >= 0).sum().item())
    if covered == 0:
        fail("the multi-hand overlay covers no pixel")

    # the ViTPose forward: the same bits in two calls; a keypoints call's host syncs
    x = torch.randn((1, 256, 192, 3), generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    with torch.no_grad():
        same_bits = torch.equal(vitpose(x), vitpose(x))
    if not same_bits:
        fail("two calls of the ViTPose forward gave other bits")
    syncs = _count_syncs(lambda: front.keypoints(crops[0]))

    # the pipeline mode's box where a ViTPose file exists: the keypoint block's
    pipe_dir = os.path.join(root, "pipeline_mode")
    hand.run(d["cropped_hoi_dir"], pipe_dir, mask_dir=d["mask_dir"], model=hamer_model,
             pose_front=front, device=dev)
    centres = {}
    for k, image_id in enumerate(HOI_IDS):
        box = front.hand_bbox(hoi_crops[k], k % 2 == 1)
        mask_box = hand._hand_bbox_from_mask(
            os.path.join(d["mask_dir"], f"{image_id}_cropped_hand_mask.png"), (512, 512))
        got_c = np.load(os.path.join(pipe_dir, f"{image_id}.npy"),
                        allow_pickle=True).item()["box_center"][0]
        if box is None or not np.allclose(got_c, (box[:2] + box[2:]) / 2.0, atol=1e-3) \
                or np.allclose(got_c, (mask_box[:2] + mask_box[2:]) / 2.0, atol=1.0):
            fail(f"pipeline mode with a ViTPose front end: {image_id}'s box centre {got_c}, "
                 f"the keypoint block's box {box}, the mask's {mask_box}")
        centres[image_id] = [round(float(c), 2) for c in got_c]

    n = {key: len(v) for key, v in calls.items()}
    secs = {key: sum(v) for key, v in calls.items()}
    say(f"hands: one {W}x{H} frame through hand/hamer.run(multi_hand=True) {frame_s:.3f} s: "
        f"person boxes {secs['person boxes']:.4f} s ({n['person boxes']} call), ViTPose "
        f"{secs['vitpose']:.4f} s ({n['vitpose']} crops, {secs['vitpose'] / n['vitpose']:.4f} "
        f"s each, the host's PIL resize included), HaMeR {secs['hamer']:.4f} s ({n_hands} "
        f"hands, {secs['hamer'] / n_hands:.4f} s each, the crop and the MANO forward "
        f"included), overlay {secs['overlay']:.4f} s; {n_hands} hands stacked (right "
        f"{res['right'].tolist()}); the overlay covers {covered} pixels; host "
        f"synchronisations per VitPoseFrontEnd.keypoints call {syncs}; two ViTPose calls "
        f"give the same bits; peak {peak_gib:.2f} GiB; launches {launches}")
    say(f"hands: pipeline mode with the ViTPose front end centres each box on the keypoint "
        f"block, not the mask: {centres}")
    shaping.remove()
    del vitpose, hamer_model, front, persons
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return dict(launches=launches, seconds=frame_s, parts=secs, hands=n_hands, syncs=syncs,
                peak_gib=peak_gib, shift=shift, raw_counts=raw_counts,
                raster_overlay=(fwd_ov, bwd_ov))


def run_serve_phase(dev, bundle) -> dict:
    """serve.py's server on 127.0.0.1 (a free port, in a thread) with the detect
    phase's learned bundle resident, as default_bundle builds it where the four
    converted detector files exist (GroundingDINO's logits lifted as there, so SAM2
    runs): GET /healthz, an unknown path's 404, then POST /segment twice on a
    1280x960 photo, each mask equal to the bundle's own call on the same photo. Prints
    each request's seconds beside the direct call's. /reconstruct runs in the pipeline
    phase (9), on its models."""
    import base64
    import io

    from PIL import Image

    from followmyhold_tpu_torch import serve
    from followmyhold_tpu_torch.tools._scene import hoi_photo

    photo = hoi_photo(seed=2)
    raw_best = []
    shaping = bundle.gdino.register_forward_hook(
        lambda mod, args, out: _shape_gdino(out, raw_best))
    timings = []
    try:
        with _serving(serve.make_server("127.0.0.1", 0, device=dev, bundle=bundle)) as url:
            health = _http(url + "/healthz")[:2]
            missing = _http(url + "/nowhere")[:2]
            if health != (200, {"status": "ok"}) or missing[0] != 404:
                fail(f"GET /healthz answered {health}, an unknown path {missing}")
            for _ in range(2):
                status, body, request_s = _http(url + "/segment",
                                                {"image": _png_b64(photo), "prompt": "object"})
                if status != 200:
                    fail(f"POST /segment answered {status}: {body}")
                mask = np.asarray(Image.open(io.BytesIO(base64.b64decode(body["mask"])))) > 0
                torch.cuda.synchronize()
                t = time.perf_counter()
                direct = bundle.segment(photo, "object")
                torch.cuda.synchronize()
                timings.append((request_s, time.perf_counter() - t))
                if mask.shape != direct.shape or not np.array_equal(mask, direct):
                    fail("POST /segment's mask differs from the bundle's own call")
    finally:
        shaping.remove()
    say(f"serve: GET /healthz 200, an unknown path 404; POST /segment (GroundingDINO and SAM2 "
        f"on a 1280x960 photo) answered in {[round(r, 4) for r, _ in timings]} s against "
        f"{[round(c, 4) for _, c in timings]} s for the bundle's own call; the mask covers "
        f"{float(mask.mean()):.4f} of the photo")
    return dict(segment=timings)


def run_entry_step(dev) -> dict:
    """followmyhold_tpu_torch.entry.entry(): one CFG denoise step of the
    full-width DiT (DIT_FULL, seeded random weights, bf16) at batch 2 on [1,3072,64]
    latents and 1,370 condition tokens, then scheduler.step. The launch counts are
    set to 0 just before the step and read just after: K1 at [2,16,4442,128] once in
    each of the 24 blocks, and no other kernel. The new latents must be finite and
    of the latents' shape. Prints the build and the step's seconds (the first call
    and a second one); the model is freed after it."""
    from followmyhold_tpu_torch.entry import entry
    from followmyhold_tpu_torch.models.hunyuan import DIT_FULL
    from followmyhold_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    fn, args = entry(device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    step_s = []
    for k in range(2):
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        if k == 0:
            launches = _kernels.launch_counts()
    n_blocks = DIT_FULL.depth_double + DIT_FULL.depth_single
    want = {k: (n_blocks if k == "flash_attention_fwd" else 0) for k in launches}
    if launches != want:
        fail(f"entry()'s step launched {launches}, not K1 once a block ({want})")
    if tuple(out.shape) != tuple(args[1].shape) or not bool(torch.isfinite(out).all()):
        fail(f"entry()'s step gave latents of shape {tuple(out.shape)} or not finite")
    say(f"entry: entry() built the DiT in {build_s:.2f} s; one CFG denoise step "
        f"{step_s[0]:.4f} s (first call), {step_s[1]:.4f} s (second); finite latents "
        f"{tuple(out.shape)}; launches {launches}")
    latents_in, latents = args[1].cpu(), out.cpu()
    del fn, args, out
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, build_s=build_s, step_s=step_s, latents_in=latents_in,
                latents=latents)


# ---- the mesh phase -------------------------------------------------------- #

# the dry run's per-image losses at dp=2 x tp=2 against the same step in one
# process without a mesh (float32 models; the tp sums run in another order, and
# a noise component of the two AdamW steps that steps the other way moves a
# loss by ~1e-3)
_MESH_DRYRUN_RTOL = 1e-3
# entry()'s CFG step at tp=2 against the unsharded step: the relative error of
# the step's update (new latents - latents). bf16 through 24 blocks, whose
# row-parallel products are summed in float32 from two bf16 halves instead of
# one bf16 product (measured 5.72e-2 on one H100)
_MESH_TP_REL_LIMIT = 2.0 ** -3
# the same step with the DiT in float32 and the plain attention: the sharding
# alone, float32 sums in another order
_MESH_TP_F32_LIMIT = 1e-4
# the dp run's configuration: the default's, with its counts cut
MESH_DP_STEPS = dict(num_inference_steps=6, optimization_steps_hand=2,
                     optimization_steps_scale=2, optimization_steps_joint=2,
                     final_octree_resolution=128)


def _dit_f32():
    from followmyhold_tpu_torch.models.hunyuan import DIT_FULL

    return dataclasses.replace(DIT_FULL, dtype=torch.float32)


def _plain_attention(q, k, v):
    from followmyhold_tpu_torch.ops.attention import attention_plain

    return attention_plain(q, k, v, scale=1.0 / math.sqrt(q.shape[-1]))


def _mesh_rank(rank: int, world: int, init_file: str, out_dir: str, scene: dict,
               device_type: str = "cuda") -> None:
    """One of the mesh phase's two ranks (on the one card, through gloo): (b)
    entry()'s CFG step with the full-width DiT sharded over tp=2, (c)
    guidance/run.run_batch_images over a dp=2 mesh on the two scenes of the
    batched stage with the full-width models; rank 0 also runs the same batch
    through GuidedSampler.run_batch without a mesh. Writes its report to
    out_dir/rank{rank}.pt; an exception ends the process with it. (device_type
    "cpu" rehearses it off the card, with the models' configurations patched
    to tiny ones.)"""
    import torch.distributed as dist

    from followmyhold_tpu_torch.configs.guidance import OptimizationConfig
    from followmyhold_tpu_torch.diffusion.guidance import GuidedSampler
    from followmyhold_tpu_torch.entry import entry
    from followmyhold_tpu_torch.geometry.hunyuan import build_models, encode_condition
    from followmyhold_tpu_torch.guidance import run as stage
    from followmyhold_tpu_torch.models import hunyuan
    from followmyhold_tpu_torch.models.hunyuan import COND_FULL, DIT_FULL, VAE_FULL
    from followmyhold_tpu_torch.ops import _kernels
    from followmyhold_tpu_torch.parallel.mesh import make_mesh, shard_model_params
    from followmyhold_tpu_torch.utils.prng import SEED_GUIDANCE, stage_generator
    from PIL import Image

    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    report = dict(rank=rank, seconds={})
    sec = report["seconds"]
    on_card = device_type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    try:
        tp_mesh = make_mesh("tp=2", device_type=device_type, backend="gloo")
        dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
        sec["rendezvous"] = time.perf_counter() - t0
        if on_card:
            _kernels.load_library()

        # (b) entry()'s step, the DiT sharded over tp: in bf16 through K1 (the main
        # path), then in float32 through the plain attention (K1 takes bf16 only),
        # which holds the sharding itself to float32 rounding at full width
        shapes, attention = [], hunyuan._attention

        def recorded(q, k, v):
            shapes.append(tuple(q.shape))
            return attention(q, k, v)

        for tag, cfg in (("bf16", DIT_FULL), ("f32", _dit_f32())):
            t = time.perf_counter()
            fn, args = entry(cfg, device=dev)
            shard_model_params(args[0], tp_mesh)
            sync()
            sec[f"tp_build_{tag}"] = time.perf_counter() - t
            hunyuan._attention = recorded if tag == "bf16" else _plain_attention
            try:
                _kernels.reset_launch_counts()
                t = time.perf_counter()
                out = fn(*args)
                sync()
                sec[f"tp_step_{tag}"] = time.perf_counter() - t
            finally:
                hunyuan._attention = attention
            if tag == "bf16":
                report["tp_launches"], report["tp_shapes"] = _kernels.launch_counts(), shapes
            report[f"tp_latents_{tag}"] = out.cpu()
            del fn, args, out
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()

        # (c) the dp run of the batched stage's two scenes
        dp_mesh = make_mesh("dp=2", device_type=device_type, backend="gloo")
        t = time.perf_counter()
        models = build_models(DIT_FULL, VAE_FULL, COND_FULL, seed=0, device=dev)
        crop = os.path.join(scene["cropped_obj_img_dir"], f"{IMAGE_ID}_cropped_inpainted.png")
        tokens, uncond = encode_condition(models[2], np.asarray(Image.open(crop).convert("RGBA")),
                                          device=dev)
        _shape_field(dev, models[0], models[1], tokens, uncond)
        sync()
        sec["dp_models"] = time.perf_counter() - t
        dirs = [scene[k] for k in ("cropped_obj_img_dir", "mask_dir", "moge_out_dir",
                                   "hunyuan_hoi_mesh_dir", "hamer_out_dir", "h2m_rt_dir",
                                   "aligned_mano_dir", "guidance_out_dir")]
        jobs = []
        for image_id in BATCH_IDS:
            job = stage._job_paths(f"{image_id}_cropped_inpainted.png", *dirs)
            job["fovx"] = stage._read_fovx(job)
            jobs.append(job)
        j_reg = np.load(os.path.join(scene["hamer_out_dir"], "J_regressor_hamer.npy"))
        config = OptimizationConfig(**MESH_DP_STEPS)
        kept, written = {}, []
        run_batch, export = GuidedSampler.run_batch, stage._export_and_write

        def keep_run_batch(self, cond_main, uncond_main, targets, *a, **k):
            # the first call is the stage's (the whole batch); with a mesh it
            # calls run_batch again on this rank's images
            outer = "cond" not in kept
            if outer:
                kept.update(sampler=self, cond=(cond_main, uncond_main), targets=targets)
            result = run_batch(self, cond_main, uncond_main, targets, *a, **k)
            if outer:
                kept["result"] = result
            return result

        def keep_export(sampler, result, targets, config, crop_path, save_obj, save_hand,
                        *a, **k):
            written.extend([save_obj, save_hand])
            return export(sampler, result, targets, config, crop_path, save_obj, save_hand,
                          *a, **k)

        GuidedSampler.run_batch, stage._export_and_write = keep_run_batch, keep_export
        try:
            sync()
            _kernels.reset_launch_counts()
            t = time.perf_counter()
            stage.run_batch_images(jobs, config, models, j_reg, device=dev, mesh=dp_mesh)
            sync()
            sec["dp_run"] = time.perf_counter() - t
            report["dp_launches"] = _kernels.launch_counts()
        finally:
            GuidedSampler.run_batch, stage._export_and_write = run_batch, export
        report["dp_written"] = written
        result = kept["result"]
        report["dp_result"] = dict(latents=result.latents.cpu(),
                                   noise_pred=result.noise_pred.cpu(),
                                   hand=[x.cpu() for x in result.hand],
                                   obj=[x.cpu() for x in result.obj],
                                   losses={k: v.cpu() for k, v in result.losses.items()})
        report["dp_sampler_seconds"] = result.seconds
        report["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
        if rank == 0:
            t = time.perf_counter()
            cond_main, uncond_main = kept["cond"]
            ref = kept["sampler"].run_batch(
                cond_main, uncond_main, kept["targets"],
                (VAE_FULL.num_latents, VAE_FULL.embed_dim), device=dev,
                generators=[stage_generator(SEED_GUIDANCE, "guidance", i, dev)
                            for i in BATCH_IDS])
            sync()
            sec["dp_reference"] = time.perf_counter() - t
            report["dp_reference"] = dict(latents=ref.latents.cpu(),
                                          noise_pred=ref.noise_pred.cpu(),
                                          hand=[x.cpu() for x in ref.hand],
                                          obj=[x.cpu() for x in ref.obj],
                                          losses={k: v.cpu() for k, v in ref.losses.items()})
        torch.save(report, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_mesh_phase(dev, entry_run: dict) -> dict:
    """The port's device mesh (followmyhold_tpu_torch/parallel/mesh.py) on the one
    card, every rank a process of its own and the collectives through gloo (NCCL
    refuses two ranks on one card):

    (a) entry.dryrun_multichip(4): dp=2 x tp=2, the tiny DiT and ShapeVAE sharded
        over tp, one guidance train step an image (a CFG DiT forward, the joint
        phase near the end, its AdamW steps through the decode, marching tets
        and the renders: K3, K4 and the scatter-add; its attentions are shorter
        than the flash path's 256 queries); its per-image losses held against
        the same step in this process without a mesh (relative _MESH_DRYRUN_RTOL);
    (b) entry()'s CFG step with DIT_FULL sharded over tp=2 on 2 ranks: K1 24 times
        a rank at [2,8,4442,128] (each rank's 8 heads), the same latents on both
        ranks, held against entry()'s unsharded step of the entry phase on the
        same seeds (the update's relative error, _MESH_TP_REL_LIMIT); then the
        same step with the DiT in float32 and the plain attention, against its
        unsharded run here (_MESH_TP_F32_LIMIT: the sharding itself);
    (c) guidance/run.run_batch_images on a dp=2 mesh of the same 2 ranks, on the
        batched stage's two scenes with the full-width DiT, ShapeVAE and
        DINOv2-G (the field shaped as in the main stage) and the counts cut
        (MESH_DP_STEPS: 6 steps, 2 hand, 2 object and 2 x 2 joint iterations, the
        export at 128^3): each rank writes its own image's PLYs, and the
        gathered GuidanceResult is held against GuidedSampler.run_batch without
        a mesh on the same inputs (rank 0, after): the same bits, or the
        difference printed and held to _BATCH_REL_LIMIT.

    Prints the seconds by part (the spawn with the imports, the rendezvous, each
    part), each rank's peak memory, and the launches per kernel summed over the
    ranks (launches_mesh: (a), (b) and (c), the reference runs left out)."""
    import tempfile

    import torch.multiprocessing as mp

    from followmyhold_tpu_torch.entry import dryrun_losses, dryrun_multichip
    from followmyhold_tpu_torch.models.hunyuan import DIT_FULL
    from followmyhold_tpu_torch.tools._scene import write_stage_inputs

    total = {}
    # (a) ------------------------------------------------------------------- #
    t = time.perf_counter()
    reports = []
    got = dryrun_multichip(4, device_type="cuda", backend="gloo", reports=reports)
    a_s = time.perf_counter() - t
    t = time.perf_counter()
    want = dryrun_losses(2, device=dev).cpu().numpy()
    ref_s = time.perf_counter() - t
    rel = np.abs(got - want) / np.abs(want)
    if not (np.isfinite(got).all() and got.shape == (2,) and (rel <= _MESH_DRYRUN_RTOL).all()):
        fail(f"mesh (a): dryrun_multichip(4)'s losses {got} against one process's {want}: "
             f"relative {rel} (limit {_MESH_DRYRUN_RTOL})")
    for r in reports:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    # at these widths every attention has fewer than 256 queries and takes the
    # plain version, as in the reference: K1 and K2 are not on this path
    if not all(total.get(k) for k in ("raster_fwd", "raster_bwd", "scatter_rows_add")):
        fail(f"mesh (a): the dry run's ranks launched {total}")
    say(f"mesh (a): dryrun_multichip(4) (dp=2, tp=2, cuda, gloo) losses {got.tolist()} against "
        f"{want.tolist()} without a mesh: relative {rel.max():.2e} (limit "
        f"{_MESH_DRYRUN_RTOL:.0e}); {a_s:.1f} s in all (ranks: rendezvous "
        f"{max(r['rendezvous_s'] for r in reports):.2f} s, step "
        f"{max(r['step_s'] for r in reports):.2f} s; the rest spawning and imports); the "
        f"same step in this process {ref_s:.2f} s; peak per rank "
        f"{[round(r['peak_gib'], 3) for r in reports]} GiB; launches summed {total}")

    # (b) and (c) ------------------------------------------------------------ #
    # entry()'s unsharded step in float32 through the plain attention, for (b)
    from followmyhold_tpu_torch.entry import entry
    from followmyhold_tpu_torch.models import hunyuan

    t = time.perf_counter()
    fn, args = entry(_dit_f32(), device=dev)
    attention, hunyuan._attention = hunyuan._attention, _plain_attention
    try:
        ref_f32 = fn(*args).cpu()
    finally:
        hunyuan._attention = attention
    del fn, args
    gc.collect()
    torch.cuda.empty_cache()
    f32_s = time.perf_counter() - t
    tmp = tempfile.mkdtemp(prefix="fmh_mesh_")
    try:
        size = 512
        for k, (image_id, fov) in enumerate(zip(BATCH_IDS, BATCH_FOVS)):
            scene = write_stage_inputs(os.path.join(tmp, "scene"), image_id=image_id, size=size,
                                       moge_grid=(size * 3 // 4, size), fov_deg=fov, seed=k)
        t = time.perf_counter()
        mp.spawn(_mesh_rank, nprocs=2, join=True,
                 args=(2, os.path.join(tmp, "rendezvous"), tmp, scene))
        bc_s = time.perf_counter() - t
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (b)
    n_blocks = DIT_FULL.depth_double + DIT_FULL.depth_single
    lat0 = entry_run["latents_in"]
    refs = dict(bf16=entry_run["latents"], f32=ref_f32)
    limits = dict(bf16=_MESH_TP_REL_LIMIT, f32=_MESH_TP_F32_LIMIT)
    tp_rel = {tag: [] for tag in refs}
    for r in ranks:
        k1 = r["tp_launches"]
        if k1 != {k: (n_blocks if k == "flash_attention_fwd" else 0) for k in k1}:
            fail(f"mesh (b): rank {r['rank']}'s tp step launched {k1}, not K1 once a block")
        if set(r["tp_shapes"]) != {(2, DIT_FULL.heads // 2, 4442, DIT_FULL.hidden
                                    // DIT_FULL.heads)}:
            fail(f"mesh (b): rank {r['rank']}'s attention shapes {set(r['tp_shapes'])}")
        for tag, ref in refs.items():
            tp_rel[tag].append(_rel_err(r[f"tp_latents_{tag}"] - lat0, ref - lat0))
        for k, v in k1.items():
            total[k] += v
    for tag in refs:
        if not torch.equal(ranks[0][f"tp_latents_{tag}"], ranks[1][f"tp_latents_{tag}"]):
            fail(f"mesh (b): the two tp ranks hold other {tag} latents")
        if not all(math.isfinite(x) and x <= limits[tag] for x in tp_rel[tag]):
            fail(f"mesh (b): the {tag} tp=2 step's update differs from the unsharded one by "
                 f"{tp_rel[tag]} relative (limit {limits[tag]})")
    sec = [r["seconds"] for r in ranks]
    say(f"mesh (b): entry()'s CFG step at tp=2 on 2 ranks: K1 {n_blocks} times a rank at "
        f"{list(ranks[0]['tp_shapes'][0])}; the update against the unsharded step: bf16 "
        f"relative {max(tp_rel['bf16']):.2e} (limit {_MESH_TP_REL_LIMIT:.2e}), float32 with the "
        f"plain attention {max(tp_rel['f32']):.2e} (limit {_MESH_TP_F32_LIMIT:.0e}); build and "
        f"shard {max(x['tp_build_bf16'] for x in sec):.2f} s, step bf16 "
        f"{max(x['tp_step_bf16'] for x in sec):.3f} s, float32 "
        f"{max(x['tp_step_f32'] for x in sec):.3f} s (the unsharded float32 reference here "
        f"{f32_s:.2f} s with its build)")

    # (c)
    for r, image_id in zip(ranks, BATCH_IDS):
        if sorted(os.path.basename(p) for p in r["dp_written"]) != [
                f"{image_id}_hand.ply", f"{image_id}_obj.ply"]:
            fail(f"mesh (c): rank {r['rank']} wrote {r['dp_written']}, not {image_id}'s files")
        for k, v in r["dp_launches"].items():
            total[k] += v
        if not r["dp_launches"]["flash_attention_bwd"] or not r["dp_launches"]["raster_bwd"]:
            fail(f"mesh (c): rank {r['rank']}'s dp run launched {r['dp_launches']}")
    got, want = ranks[1]["dp_result"], ranks[0]["dp_reference"]

    def leaves(x):
        return [("latents", x["latents"]), ("noise_pred", x["noise_pred"]),
                *((f"hand.{i}", v) for i, v in enumerate(x["hand"])),
                *((f"obj.{i}", v) for i, v in enumerate(x["obj"])),
                *((f"losses.{k}", x["losses"][k]) for k in sorted(x["losses"]))]

    if sorted(got["losses"]) != sorted(want["losses"]):
        fail(f"mesh (c): phases {sorted(got['losses'])} against {sorted(want['losses'])}")
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(leaves(got), leaves(want)))
    diffs = {n: (a.float() - b.float()).abs().max().item()
             for (n, a), (_, b) in zip(leaves(got), leaves(want))}
    dp_rel = max(_rel_err(got[k], want[k]) for k in ("latents", "noise_pred"))
    if not all(torch.equal(a, b) for (_, a), (_, b) in zip(leaves(ranks[0]["dp_result"]),
                                                             leaves(got))):
        fail("mesh (c): the two dp ranks returned other results")
    if not (math.isfinite(dp_rel) and dp_rel <= _BATCH_REL_LIMIT):
        fail(f"mesh (c): the dp=2 run differs from run_batch without a mesh by {dp_rel} "
             f"relative (limit {_BATCH_REL_LIMIT}); max |diff| by leaf {diffs}")
    bits = "the same bits" if same else f"NOT the same bits: max |diff| by leaf {diffs}"
    sampler_s = [round(sum(x["dit_steps"]) + x["hand"] + x["obj"] + x["joint"], 2)
                 for x in (r["dp_sampler_seconds"] for r in ranks)]
    say(f"mesh (c): run_batch_images on dp=2 ({MESH_DP_STEPS}) against run_batch without a "
        f"mesh: {bits}; each rank wrote its own image's PLYs; models built and the field "
        f"shaped {max(x['dp_models'] for x in sec):.2f} s, the dp run "
        f"{[round(x['dp_run'], 2) for x in sec]} s (sampler {sampler_s} s), the reference "
        f"without a mesh (two images) {sec[0]['dp_reference']:.2f} s")
    rendezvous = [round(x["rendezvous"], 2) for x in sec]
    say(f"mesh: (b) and (c) {bc_s:.1f} s in all: rendezvous {rendezvous} s, the rest of it "
        f"spawning and imports; peak per rank "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB; launches summed over the ranks "
        f"(a, b, c) {total}")
    return dict(launches=total, dryrun_rel=rel.tolist(), tp_rel=tp_rel, dp_same_bits=same,
                dp_diffs=diffs, seconds=dict(a=a_s, bc=bc_s, ranks=sec))


CONVERT_SEED = 14
DETECTOR_FILES = ("yolov8_wilor", "hand_object_detector", "gdino", "sam2")
CONVERT_CUT_DEPTH = 2          # the FLUX transformer's and T5-XXL's blocks in the phase


def _load_transient_gib() -> float:
    """The card's peak since the last ``reset_peak_memory_stats`` above what is
    allocated now (GiB): what a load held on the card beyond the model it left."""
    return (torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()) / 2 ** 30


def _host_peak_gib() -> float:
    """The process's peak resident host memory so far (GiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def _gb(n_bytes: float) -> float:
    return n_bytes / 1e9


@contextlib.contextmanager
def _clocked(module, names, record: dict):
    """Each function ``names`` of ``module`` timed (host wall clock, seconds
    summed in record[name]) and its results kept (record[name + ":out"])."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            record[name] = record.get(name, 0.0) + time.perf_counter() - t0
            record.setdefault(name + ":out", []).append(out)
            return out
        return wrapped

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield record
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def _same_parameters(got, want, what: str) -> None:
    """Every parameter of ``got`` equal to ``want``'s, bit for bit."""
    w = dict(want.named_parameters())
    for name, p in got.named_parameters():
        if p.dtype != w[name].dtype or not torch.equal(p, w[name]):
            fail(f"convert: {what}'s {name} loaded from its file differs from the tree "
                 f"bridged in memory")


def _reports_clean(outs, what: str) -> None:
    """Every converter's (tree, report) in ``outs`` with nothing missing or unused."""
    for _, report in outs:
        if report.missing_src or report.unused_src:
            fail(f"convert: {what} left {len(report.missing_src)} missing and "
                 f"{len(report.unused_src)} unused: {report.missing_src[:4]} "
                 f"{report.unused_src[:4]}")


def run_convert_phase(dev, configs: dict = None) -> dict:
    """The checkpoint converters, as a user runs them, inside a temporary
    FOHO_TPU_ASSETS (restored afterwards, so later phases keep their seeded
    random weights; the directory is removed at the end).

    (a) The guidance stage's three files at full width and depth: a Hunyuan3D-2
    model.ckpt ({"model", "vae", "conditioner"} in the reference's names, fp16 as
    published, drawn on the card from a seeded torch.Generator; tools._checkpoints)
    written with torch.save, then convert.hunyuan's main on it, as
    ``python -m followmyhold_tpu_torch.convert.hunyuan --ckpt`` runs it (each report
    0 missing, 0 unused). geometry/hunyuan.build_models loads the three files onto
    the card (has_params true for each); every parameter must equal, bit for bit,
    the same trees converted in memory and bridged with flax_to_torch. One CFG DiT
    step of entry() on the loaded DiT: the launch counts are set to 0 just before
    and read just after (K1 exactly 24 times, nothing else), finite latents, the
    same bits as the step of the bridged DiT. Prints each part's seconds and GB/s
    (synthesising, torch.save, torch.load, converting, save_params with the file
    sizes, read_params_file and the load onto the card) and the host's and the
    card's peak memory.

    (b) Every other converter at its published width: MoGe, HaMeR, ViTPose, the
    FLUX VAE, CLIP-L, GroundingDINO, SAM2, the Faster R-CNN and YOLOv8-n through
    their main at full depth; the FLUX transformer and T5-XXL through
    convert_flux_transformer / convert_t5_encoder with depth cut to
    CONVERT_CUT_DEPTH blocks. Each 0 missing and 0 unused, loaded on the card
    (MoGe and HaMeR through their stage's build function, the four detectors through
    LearnedBundle, the rest through load_params), one forward each with finite
    outputs. ``configs`` replaces the full-size configurations (a CPU rehearsal)."""
    import dataclasses
    import tempfile

    from followmyhold_tpu_torch.convert import common as CC
    from followmyhold_tpu_torch.convert import flux as CF
    from followmyhold_tpu_torch.convert import flux_text as CT
    from followmyhold_tpu_torch.convert import gdino as CG
    from followmyhold_tpu_torch.convert import hamer as CH
    from followmyhold_tpu_torch.convert import hand_object as CR
    from followmyhold_tpu_torch.convert import hunyuan as CHY
    from followmyhold_tpu_torch.convert import moge as CM
    from followmyhold_tpu_torch.convert import sam2 as CS
    from followmyhold_tpu_torch.convert import vitpose as CV
    from followmyhold_tpu_torch.convert import yolov8 as CY
    from followmyhold_tpu_torch.entry import entry
    from followmyhold_tpu_torch.geometry import hunyuan as GH
    from followmyhold_tpu_torch.models import clip_text as MC
    from followmyhold_tpu_torch.models import flux as MF
    from followmyhold_tpu_torch.models import gdino as MG
    from followmyhold_tpu_torch.models import hamer as MH
    from followmyhold_tpu_torch.models import hand_object_detector as MR
    from followmyhold_tpu_torch.models import hunyuan as MHY
    from followmyhold_tpu_torch.models import moge as MM
    from followmyhold_tpu_torch.models import sam2 as MS
    from followmyhold_tpu_torch.models import t5 as MT
    from followmyhold_tpu_torch.models import vitpose as MV
    from followmyhold_tpu_torch.models import yolov8 as MY
    from followmyhold_tpu_torch.ops import _kernels
    from followmyhold_tpu_torch.tools import _checkpoints as CK
    from followmyhold_tpu_torch.utils import params as P

    cfg = {"dit": MHY.DIT_FULL, "vae": MHY.VAE_FULL, "cond": MHY.COND_FULL,
           "moge": MM.MoGeConfig(), "hamer": MH.HamerConfig(), "vitpose": MV.ViTPoseConfig(),
           "flux_vae": MF.FLUX_VAE, "clip": MC.CLIP_L, "yolo": MY.YOLOV8_N,
           "frcnn": MR.FrcnnConfig(), "gdino": MG.GDINO_BASE, "sam2": MS.SAM2_LARGE,
           "flux": dataclasses.replace(MF.FLUX_DEV, num_layers=CONVERT_CUT_DEPTH,
                                       num_single_layers=CONVERT_CUT_DEPTH),
           "t5": dataclasses.replace(MT.T5_XXL, num_layers=CONVERT_CUT_DEPTH),
           **(configs or {})}
    hunyuan = {"model": ("hunyuan_dit", MHY.HunyuanDiT(cfg["dit"], device="meta")),
               "vae": ("hunyuan_vae", MHY.ShapeVAE(cfg["vae"], device="meta")),
               "conditioner": ("hunyuan_cond", MHY.Conditioner(cfg["cond"], device="meta"))}
    # (a)'s footprint on disk: the fp16 checkpoint and the float32 files, with 10 % room
    need_gb = 1.1 * _gb(6 * sum(p.numel() for _, m in hunyuan.values() for p in m.parameters()))
    root = tempfile.mkdtemp(prefix="fmh_convert_")
    free_gb = _gb(shutil.disk_usage(root).free)
    if free_gb < need_gb:
        shutil.rmtree(root, ignore_errors=True)
        fail(f"convert: {free_gb:.1f} GB free under {root}, the phase needs {need_gb:.1f} GB")
    before_assets = os.environ.get("FOHO_TPU_ASSETS")
    os.environ["FOHO_TPU_ASSETS"] = os.path.join(root, "assets")
    gen = torch.Generator(device=dev)
    gen.manual_seed(CONVERT_SEED)
    draw = CK.seeded_draw(gen, torch.float16, dev)

    def synthesise(name, model):
        """(a host state dict of the reference's names, seconds, bytes)"""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sd = {k: v.cpu() for k, v in CK.state_dict(name, model, draw).items()}
        secs = time.perf_counter() - t0
        return sd, secs, sum(v.numel() * v.element_size() for v in sd.values())

    def save(obj, path):
        t0 = time.perf_counter()
        torch.save(obj, path)
        return time.perf_counter() - t0, os.path.getsize(path)

    out = {}
    try:
        # ---- (a) Hunyuan3D-2 through the command line -------------------------- #
        torch.cuda.reset_peak_memory_stats()
        host0 = _host_peak_gib()
        ckpt, synth_s, synth_b = {}, 0.0, 0
        for key, (name, model) in hunyuan.items():
            ckpt[key], s, b = synthesise(name, model)
            synth_s, synth_b = synth_s + s, synth_b + b
        path = os.path.join(root, "model.ckpt")
        save_s, ckpt_b = save(ckpt, path)
        del ckpt
        gc.collect()
        rec = {}
        with _clocked(CHY, ("load_checkpoint", "convert_dit", "convert_vae",
                            "convert_conditioner", "save_params"), rec), \
                contextlib.redirect_stdout(sys.stderr):
            t0 = time.perf_counter()
            CHY.main(["--ckpt", path])
            main_s = time.perf_counter() - t0
        for n in ("convert_dit", "convert_vae", "convert_conditioner"):
            _reports_clean(rec[n + ":out"], n)
        files = {os.path.basename(p): os.path.getsize(p) for p in rec["save_params:out"]}
        if sorted(files) != ["hunyuan_cond.msgpack", "hunyuan_dit.msgpack",
                             "hunyuan_vae.msgpack"]:
            fail(f"convert: convert.hunyuan wrote {sorted(files)}")
        if not all(P.has_params(n) for n in ("hunyuan_dit", "hunyuan_vae", "hunyuan_cond")):
            fail("convert: has_params is false for one of the three converted files")
        convert_s = sum(rec[n] for n in ("convert_dit", "convert_vae", "convert_conditioner"))
        host_a = _host_peak_gib()

        t0 = time.perf_counter()
        tree = P.read_params_file(P.params_path("hunyuan_dit"))
        n_leaves = sum(1 for _ in P._flatten(tree))
        read_s = time.perf_counter() - t0
        del tree
        torch.cuda.synchronize()
        card_pre = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dit, vae, cond = GH.build_models(cfg["dit"], cfg["vae"], cfg["cond"], device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_transient = _load_transient_gib()
        say(f"convert: hunyuan model.ckpt synthesised ({_gb(synth_b):.2f} GB fp16, "
            f"{synth_s:.2f} s), torch.save {save_s:.2f} s ({_gb(ckpt_b) / save_s:.2f} GB/s); "
            f"main {main_s:.2f} s: torch.load {rec['load_checkpoint']:.2f} s, converting "
            f"{convert_s:.2f} s ({_gb(ckpt_b) / convert_s:.2f} GB/s of fp16 in; dit "
            f"{rec['convert_dit']:.2f}, vae {rec['convert_vae']:.2f}, conditioner "
            f"{rec['convert_conditioner']:.2f}), save_params {rec['save_params']:.2f} s "
            f"({_gb(sum(files.values())) / rec['save_params']:.2f} GB/s; "
            + ", ".join(f"{n} {_gb(b):.3f} GB" for n, b in sorted(files.items()))
            + f"); read_params_file of hunyuan_dit {read_s:.3f} s ({n_leaves} leaves, "
            f"{_gb(files['hunyuan_dit.msgpack']) / read_s:.1f} GB/s, a memory map); "
            f"build_models with the three files onto the card {build_s:.2f} s "
            f"({_gb(sum(files.values())) / build_s:.2f} GB/s; the files' pages warm; the "
            f"card's transient above the loaded models {build_transient:.3f} GiB)")

        # the same trees converted in memory and bridged
        ckpt = CC.load_checkpoint(path)
        fn, args = entry(cfg=cfg["dit"], device=dev)
        latents, cond_tokens, step_index = args[1:]
        del args                  # entry()'s own random DiT
        for key, model, convert in (("model", dit, CHY.convert_dit), ("vae", vae, CHY.convert_vae),
                                    ("conditioner", cond, CHY.convert_conditioner)):
            tree, _ = convert(ckpt[key], model.cfg)
            twin = P.flax_to_torch(tree, type(model)(model.cfg, device=dev))
            del tree
            _same_parameters(model, twin, key)
            if key != "model":
                del twin
            else:
                bridged = twin.eval().requires_grad_(False)
        del ckpt
        gc.collect()
        step_s = []
        for k in range(2):
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            new = fn(dit, latents, cond_tokens, step_index)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if k == 0:
                launches = _kernels.launch_counts()
        n_blocks = cfg["dit"].depth_double + cfg["dit"].depth_single
        want = {k: (n_blocks if k == "flash_attention_fwd" else 0) for k in launches}
        if launches != want:
            fail(f"convert: the loaded DiT's CFG step launched {launches}, not {want}")
        if not bool(torch.isfinite(new).all()):
            fail("convert: the loaded DiT's CFG step gave latents that are not finite")
        twin_new = fn(bridged, latents, cond_tokens, step_index)
        if not torch.equal(new, twin_new):
            fail("convert: the loaded DiT's CFG step differs from the bridged DiT's")
        card_a = max(card_pre, torch.cuda.max_memory_allocated()) / 2 ** 30
        say(f"convert: the loaded DiT, VAE and conditioner equal the in-memory bridge bit "
            f"for bit; one CFG step {step_s[0]:.4f} s (first call), {step_s[1]:.4f} s "
            f"(second), launches {launches}, the same bits as "
            f"the bridged DiT's; peak memory: host {host_a:.2f} GiB (before the phase "
            f"{host0:.2f}), card {card_a:.2f} GiB")
        out.update(launches=launches, hunyuan=dict(
            synth_s=synth_s, ckpt_gb=_gb(ckpt_b), save_s=save_s, main_s=main_s,
            load_s=rec["load_checkpoint"], convert_s=convert_s, save_params_s=rec["save_params"],
            files_gb={n: _gb(b) for n, b in files.items()}, read_s=read_s, build_s=build_s,
            build_transient_gib=build_transient,
            step_s=step_s, host_peak_gib=host_a, card_peak_gib=card_a))
        del dit, vae, cond, bridged, new, twin_new, latents, cond_tokens, fn
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (b) every other converter ------------------------------------------ #
        from followmyhold_tpu_torch.geometry import moge as GM
        from followmyhold_tpu_torch.hand import hamer as HH
        from followmyhold_tpu_torch.preprocess.detectors import LearnedBundle
        from followmyhold_tpu_torch.tools._scene import hoi_photo

        def through_main(mod, convert, name, model, argv, wrap=lambda sd: sd):
            """The checkpoint written as the reference ships it and converted by
            ``mod.main`` (its report 0 missing, 0 unused)."""
            sd, synth_s, synth_b = synthesise(name, model)
            p = os.path.join(root, f"{name}.pt")
            save_s, _ = save(wrap(sd), p)
            del sd
            r = {}
            with _clocked(mod, (convert,), r), contextlib.redirect_stdout(sys.stderr):
                t0 = time.perf_counter()
                mod.main(argv(p))
                secs = time.perf_counter() - t0
            _reports_clean(r[convert + ":out"], name)
            os.remove(p)
            return dict(synth_s=synth_s, ckpt_gb=_gb(synth_b), save_s=save_s, main_s=secs)

        def in_memory(convert, name, model, model_cfg):
            """The depth-cut models: converted in memory and saved as ``name``."""
            sd, synth_s, synth_b = synthesise(name, model)
            t0 = time.perf_counter()
            tree, report = convert(sd, model_cfg)
            secs = time.perf_counter() - t0
            _reports_clean([(tree, report)], name)
            del sd
            P.save_params(name, tree)
            return dict(synth_s=synth_s, ckpt_gb=_gb(synth_b), save_s=None, main_s=secs)

        meta, y = "meta", cfg["yolo"]
        runs = {
            "moge": through_main(CM, "convert_moge", "moge", MM.MoGe(cfg["moge"], device=meta),
                                 lambda p: ["--ckpt", p], lambda sd: {"model": sd}),
            "hamer": through_main(CH, "convert_hamer", "hamer",
                                  MH.Hamer(cfg["hamer"], device=meta), lambda p: ["--ckpt", p],
                                  lambda sd: {"state_dict": sd, "epoch": 0}),
            "vitpose": through_main(CV, "convert_vitpose", "vitpose",
                                    MV.ViTPose(cfg["vitpose"], device=meta),
                                    lambda p: ["--ckpt", p], lambda sd: {"state_dict": sd}),
            "flux_vae": through_main(CF, "convert_flux_vae", "flux_vae",
                                     MF.FluxVae(cfg["flux_vae"], device=meta),
                                     lambda p: ["--vae", p]),
            "flux_clip": through_main(CT, "convert_clip_text", "flux_clip",
                                      MC.ClipTextModel(cfg["clip"], device=meta),
                                      lambda p: ["--clip_ckpt", p, "--clip_tokenizer_dir",
                                                 os.path.join(root, "tokenizer")]),
            "gdino": through_main(CG, "convert_gdino", "gdino",
                                  MG.GroundingDino(cfg["gdino"], device=meta),
                                  lambda p: ["--ckpt", p]),
            "sam2": through_main(CS, "convert_sam2", "sam2", MS.Sam2(cfg["sam2"], device=meta),
                                 lambda p: ["--ckpt", p], lambda sd: {"model": sd}),
            "hand_object_detector": through_main(
                CR, "convert_hand_object", "hand_object_detector",
                MR.HandObjectDetector(cfg["frcnn"], device=meta), lambda p: ["--ckpt", p],
                lambda sd: {"model": sd, "epoch": 8}),
            "yolov8_wilor": through_main(
                CY, "convert_yolov8", "yolov8_wilor", MY.YoloV8(y, device=meta),
                lambda p: ["--ckpt", p, "--width", str(y.base_width), "--depth_mult",
                           str(y.depth_mult), "--num_classes", str(y.num_classes)]),
            "flux_transformer": in_memory(CF.convert_flux_transformer, "flux_transformer",
                                          MF.FluxTransformer(cfg["flux"], device=meta),
                                          cfg["flux"]),
            "flux_t5": in_memory(CT.convert_t5_encoder, "flux_t5",
                                 MT.T5Encoder(cfg["t5"], device=meta), cfg["t5"]),
        }

        # loaded on the card, one forward each
        rng = np.random.default_rng(CONVERT_SEED)
        photo = hoi_photo(seed=0)

        def forward(name, build, call):
            """``build()`` (timed as the load onto the card), then one forward."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = build()
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            transient = _load_transient_gib()
            _kernels.reset_launch_counts()
            with torch.no_grad():
                got = call(model)
            torch.cuda.synchronize()
            if not _outputs_finite("gdino" if name == "gdino" else name, got):
                fail(f"convert: {name}'s forward on its converted file is not finite")
            runs[name].update(load_s=load_s, transient_gib=transient, launches={
                k: v for k, v in _kernels.launch_counts().items() if v})
            return got

        img = torch.from_numpy(rng.uniform(size=(1, 256, 256, 3)).astype(np.float32)).to(dev)
        forward("moge", lambda: GM._build_model(cfg["moge"], device=dev),
                lambda m: m(img, 1200))
        forward("hamer", lambda: HH._build_model(cfg["hamer"], device=dev), lambda m: m(img))
        vp = cfg["vitpose"].backbone.img_size
        forward("vitpose", lambda: P.load_params("vitpose", MV.ViTPose(cfg["vitpose"], device=dev)),
                lambda m: m(img[:, :vp[0], :vp[1]]))
        forward("flux_vae", lambda: P.load_params("flux_vae", MF.FluxVae(cfg["flux_vae"],
                                                                          device=dev)),
                lambda m: m.decode(m.encode(img * 2 - 1)))
        ids = torch.arange(cfg["clip"].max_position_embeddings, device=dev)[None] % 1000
        forward("flux_clip", lambda: P.load_params("flux_clip",
                                                   MC.ClipTextModel(cfg["clip"], device=dev)),
                lambda m: m(ids))
        forward("flux_t5", lambda: P.load_params("flux_t5", MT.T5Encoder(cfg["t5"], device=dev)),
                lambda m: m(ids))
        fc = cfg["flux"]
        n_img, n_txt = 256, 32
        forward("flux_transformer",
                lambda: P.load_params("flux_transformer", MF.FluxTransformer(fc, device=dev)),
                lambda m: m(torch.randn(1, n_img, fc.in_channels, device=dev),
                            torch.randn(1, n_txt, fc.joint_dim, device=dev),
                            torch.randn(1, fc.pooled_dim, device=dev),
                            torch.full((1,), 0.5, device=dev),
                            torch.from_numpy(MF.latent_ids(16, 16)).to(dev),
                            torch.zeros(n_txt, 3, device=dev),
                            torch.full((1,), 2.5, device=dev)))
        # the four detectors through the stage's build function, which loads all four files
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle = LearnedBundle(device=dev, configs={k: cfg[k] for k in ("yolo", "frcnn",
                                                                         "gdino", "sam2")})
        torch.cuda.synchronize()
        bundle_s = time.perf_counter() - t0
        forward("yolov8_wilor", lambda: bundle.yolo,
                lambda m: m(torch.rand(1, y.image_size, y.image_size, 3, device=dev)))
        blob, _ = MR.preprocess_image(photo)
        forward("hand_object_detector", lambda: bundle.frcnn,
                lambda m: m(torch.from_numpy(np.ascontiguousarray(blob)).to(dev)))
        forward("gdino", lambda: bundle.gdino,
                lambda m: m(**{k: v.to(dev) for k, v in MG.preprocess_inputs(
                    photo[:512, :512], np.array([[101, 2000, 1012, 102]]),
                    cfg["gdino"].image_size).items()}))
        s2 = cfg["sam2"].image_size
        forward("sam2", lambda: bundle.sam,
                lambda m: m(torch.rand(1, s2, s2, 3, device=dev),
                            torch.tensor([[0.2, 0.2, 0.7, 0.8]], device=dev)))
        del bundle
        for name, r in runs.items():
            how = (f"converted in memory {r['main_s']:.2f} s" if r["save_s"] is None else
                   f"torch.save {r['save_s']:.2f} s, main {r['main_s']:.2f} s")
            load = (f"onto the card {r['load_s']:.2f} s (transient above the model "
                    f"{r['transient_gib']:.3f} GiB)" if name not in DETECTOR_FILES
                    else "onto the card with the other detectors")
            say(f"convert: {name}: {r['ckpt_gb']:.3f} GB fp16 synthesised in "
                f"{r['synth_s']:.2f} s, {how}, loaded {load}; forward finite, launches "
                f"{r['launches']}")
        say(f"convert: LearnedBundle loaded the four detector files onto the card in "
            f"{bundle_s:.2f} s")
        say(f"convert: FLUX.1-Kontext's transformer and T5-XXL at full width, depth cut to "
            f"{CONVERT_CUT_DEPTH} blocks each (double and single for the transformer); "
            f"every report 0 missing and 0 unused; host peak {_host_peak_gib():.2f} GiB")
        out["others"] = runs
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if before_assets is None:
            os.environ.pop("FOHO_TPU_ASSETS", None)
        else:
            os.environ["FOHO_TPU_ASSETS"] = before_assets
        gc.collect()
        torch.cuda.empty_cache()
    return out


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
    finite, 57 x 28 K1 and 76 x 28 qk_norm_rope launches an image and no other
    kernel, two 2-step kontext_edit calls with the same bits, and one full-width
    transformer forward with K1 against the same forward with the plain
    attention. Prints s per image
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
        # the attention prologue: one launch a stream, two in a double block
        want["qk_norm_rope"] = (2 * F.FLUX_DEV.num_layers + F.FLUX_DEV.num_single_layers) \
            * n_steps * n
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

    level5 = _stage5_level(dev, models, [
        (image_id, os.path.join(d["cropped_hoi_wo_bckg_dir"],
                                f"{image_id}_cropped_hoi_{k % 2}.png"))
        for k, image_id in enumerate(HOI_IDS)])
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
    batched = run_batched_stage(dev, (dit, vae, cond), one_image_s=stage_s)
    return dict(launches=launches, hoi=hoi, batched=batched, models=(dit, vae, cond))


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


# each image of a reduced batched run (_TWO_RUN_CONFIG) against that image's own
# GuidedSampler.run on the same initial noise, at the CPU test's tolerance
# (tests/test_torch_guidance_batch.py: the DiT and the phases at another batch size
# may sum in another order, which the optimizers amplify): 1e-3 on the latents, the
# noise prediction and the poses, 1e-3 relative on the loss curves
_BATCH_RUN_ATOL = 1e-3
_BATCH_RUN_RTOL = 1e-3


def _phase_runner(sampler, phase: str, iters: int, state: dict):
    """A closure that runs one phase of ``sampler`` (its config's counts set to
    ``iters``) on ``state``'s batch: poses, noise, latents, stacked targets."""
    config = dataclasses.replace(sampler.config, optimization_steps_hand=iters,
                                 optimization_steps_scale=iters, optimization_steps_joint=iters)
    s = dataclasses.replace(sampler, config=config)
    sched = s._schedule(config.num_inference_steps)
    i_obj = config.handopt_start_step + 1
    if phase == "hand":
        return lambda: s._hand_phase_batch(state["hand"], state["targets"])
    if phase == "obj":
        return lambda: s._obj_phase_batch(state["obj"], state["noise"], state["latents"],
                                          state["targets"], sched, i_obj)
    return lambda: s._joint_phase_batch(state["hand"], state["obj"], state["noise"],
                                        state["latents"], state["targets"], sched, i_obj + 1,
                                        near_end=False)


def _per_iteration(sampler, phase: str, state: dict) -> dict:
    """One phase's cost per iteration on ``state``'s batch, each number the
    difference of a 5-iteration and a 1-iteration run over 4 (the phase's set-up
    cancels): wall ms, host syncs, device launches and device ms (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    runs = {k: _phase_runner(sampler, phase, k, state) for k in (1, 5)}
    runs[1]()                                      # first calls
    wall, syncs, launches, device = {}, {}, {}, {}
    for k, run in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall[k] = (time.perf_counter() - t0) * 1e3
        syncs[k] = _count_syncs(run)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        launches[k] = sum(e.count for e in kern)
        device[k] = sum(e.self_device_time_total for e in kern) / 1e3
    return {name: (x[5] - x[1]) / 4 for name, x in (("wall_ms", wall), ("syncs", syncs),
                                                     ("launches", launches),
                                                     ("device_ms", device))}


def _check_batch_against_run(dev, sampler, targets, cond_main, uncond_main) -> dict:
    """Each image of a reduced run_batch (_TWO_RUN_CONFIG, every phase) against
    that image's own run on the same initial noise (_BATCH_RUN_ATOL/RTOL)."""
    from followmyhold_tpu_torch.configs.guidance import OptimizationConfig

    s = dataclasses.replace(sampler, config=OptimizationConfig(**_TWO_RUN_CONFIG))
    shape = (s.vae.cfg.num_latents, s.vae.cfg.embed_dim)
    noise = torch.randn((len(targets), 1, *shape),
                        generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    t0 = time.perf_counter()
    both = s.run_batch(cond_main, uncond_main, targets, shape, initial_noise=noise, device=dev)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    diffs, same, one_s = [], True, []
    for b, tg in enumerate(targets):
        t0 = time.perf_counter()
        one = s.run(cond_main[b], uncond_main[b], tg, shape, initial_noise=noise[b], device=dev)
        torch.cuda.synchronize()
        one_s.append(time.perf_counter() - t0)
        leaves = [("latents", both.latents[b], one.latents),
                  ("noise_pred", both.noise_pred[b], one.noise_pred),
                  *((f"{name}.{f}", getattr(getattr(both, name), f)[b],
                     getattr(getattr(one, name), f))
                    for name in ("hand", "obj") for f in ("scale", "trans", "quat"))]
        d = {k: (x - y).abs().max().item() for k, x, y in leaves}
        d.update({f"loss {tag}": ((both.losses[tag][b] - c).abs()
                                  / c.abs().clamp(min=1e-12)).max().item()
                  for tag, c in one.losses.items()})
        same = same and all(torch.equal(x, y) for _, x, y in leaves) and all(
            torch.equal(both.losses[tag][b], c) for tag, c in one.losses.items())
        bad = {k: v for k, v in d.items()
               if not (math.isfinite(v) and v <= (_BATCH_RUN_RTOL if k.startswith("loss")
                                                   else _BATCH_RUN_ATOL))}
        if bad:
            fail(f"batch: image {b} of a reduced run_batch differs from its own run: {bad}")
        diffs.append(max(d.values()))
    say(f"batch: a reduced run_batch ({_TWO_RUN_CONFIG}) against each image's run on the "
        f"same noise: largest difference {[f'{x:.2e}' for x in diffs]} (limits "
        f"{_BATCH_RUN_ATOL:.0e} absolute, {_BATCH_RUN_RTOL:.0e} relative on the losses); "
        f"{'the same bits' if same else 'not the same bits'}; {batch_s:.2f} s for both, "
        f"{', '.join(f'{x:.2f}' for x in one_s)} s one at a time")
    return dict(max_diff=diffs, same_bits=same, batch_s=batch_s, one_s=one_s)


def run_batched_stage(dev, models, one_image_s: float = None) -> dict:
    """The guidance stage on two images in one batch, as a user runs it:
    guidance/run.run(batch_size=2) over two write_stage_inputs scenes at 50 and
    70 degrees (each image's field of view in its own targets), with the main
    path's full-width models (run's build_models hands them over: the
    ShapeVAE's field is shaped, see _shape_field), the default
    OptimizationConfig and the 384^3 export. The DiT runs once a step for both
    images (K1 at [4,16,4442,128]) and each phase once a step for both (the
    batched phases: one render, decode and marching tets an iteration), the
    exports in a two-worker pool. The launch counts are set to 0 just before
    and read just after. It prints s per image beside one image's stage in the
    same call (``one_image_s``), the DiT step at batch 4, ms per image and
    iteration, the peak memory, and then, for each phase of the batch and of
    its first image alone on the stage's final state, per iteration: wall ms,
    host syncs, device launches and device ms. It checks both images' PLYs,
    that the two optimized poses differ, each image's batched DiT prediction
    against its batch-2 one, and each image of a reduced run_batch against its
    own run (_check_batch_against_run)."""
    import tempfile

    from followmyhold_tpu_torch.configs.profiles import crop_size, optimization_config
    from followmyhold_tpu_torch.diffusion.guidance import GuidedSampler, stack_targets
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

    def run_batch(self, cond_main, uncond_main, targets, *a, **k):
        kept["cond"], kept["sampler"], kept["targets"] = (cond_main, uncond_main), self, targets
        kept["result"] = _timed(run_batch_orig, calls, "sampler")(self, cond_main, uncond_main,
                                                                    targets, *a, **k)
        return kept["result"]

    GuidedSampler.run_batch = run_batch
    stage.build_models = lambda *a, **k: models
    stage._export_and_write = _timed(export_orig, calls, "export")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stage.run(root, *dirs, batch_size=2, device=dev)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        launches = _kernels.launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
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
    per_image = {"hand": sec["hand"] / (n * n_hand) * 1e3, "obj": sec["obj"] / (n * n_obj) * 1e3,
                 "joint": sec["joint"] / (n * n_joint) * 1e3}
    against = "" if one_image_s is None else f" (one image's stage in this call {one_image_s:.2f} s)"
    say(f"batch: guidance stage on {n} images in one batch ({dict(zip(BATCH_IDS, BATCH_FOVS))} "
        f"degrees) {stage_s:.2f} s, {stage_s / n:.2f} s per image{against}: sampler "
        f"{calls['sampler'][0]:.2f} s (DiT step at batch {2 * n} median "
        f"{float(np.median(dit_s)):.4f} s, first {dit_s[0]:.4f} s; hand "
        f"{per_image['hand']:.2f}, object {per_image['obj']:.2f}, joint "
        f"{per_image['joint']:.2f} ms per image and iteration, the phases batched); exports "
        f"(two at once) {', '.join(f'{x:.2f}' for x in calls['export'])} s; peak memory "
        f"{peak_gib:.2f} GiB; launches {launches}")

    # ---- per iteration: the batch, and its first image alone ----------------- #
    sampler = kept["sampler"]
    targets = [t.to(dev) for t in kept["targets"]]
    state = dict(targets=stack_targets(targets, sampler.camera), hand=result.hand,
                 obj=result.obj, noise=result.noise_pred[:, 0], latents=result.latents[:, 0])
    first = dict(targets=stack_targets(targets[:1], sampler.camera),
                 hand=type(result.hand)(*(x[:1] for x in result.hand)),
                 obj=type(result.obj)(*(x[:1] for x in result.obj)),
                 noise=state["noise"][:1], latents=state["latents"][:1])
    iteration = {}
    for phase in ("hand", "obj", "joint"):
        iteration[phase] = {"batch": _per_iteration(sampler, phase, state),
                            "one": _per_iteration(sampler, phase, first)}
        b, o = iteration[phase]["batch"], iteration[phase]["one"]
        say(f"batch: {phase} iteration, {n} images batched against one image: wall "
            f"{b['wall_ms']:.2f} / {o['wall_ms']:.2f} ms ({b['wall_ms'] / n:.2f} ms per image), "
            f"host syncs {b['syncs']:.1f} / {o['syncs']:.1f}, device launches "
            f"{b['launches']:.0f} / {o['launches']:.0f}, device {b['device_ms']:.2f} / "
            f"{o['device_ms']:.2f} ms")

    # ---- checks -------------------------------------------------------------- #
    for image_id in BATCH_IDS:
        paths = [os.path.join(d["guidance_out_dir"], f"{image_id}_{part}.ply")
                 for part in ("obj", "hand")]
        if not all(os.path.exists(p) and os.path.getmtime(p) >= t0 - 1.0 for p in paths):
            fail(f"the batched run did not write both PLYs of {image_id}")
        obj_ply, hand_ply = load_mesh(paths[0]), load_mesh(paths[1])
        if not (obj_ply.num_faces > 0 and np.isfinite(obj_ply.vertices).all()
                and hand_ply.num_vertices == 778 and np.isfinite(hand_ply.vertices).all()):
            fail(f"{image_id}'s PLYs of the batched run are empty or not finite: object "
                 f"{obj_ply.num_faces} faces, finite {np.isfinite(obj_ply.vertices).all()}; "
                 f"hand {hand_ply.num_vertices} verts, finite "
                 f"{np.isfinite(hand_ply.vertices).all()}")
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
    against_run = _check_batch_against_run(dev, sampler, targets, cond_main, uncond_main)
    # the phases render, decode and query once an iteration for both images
    n_blocks = DIT_FULL.depth_double + DIT_FULL.depth_single
    want = {"flash_attention_fwd": n_blocks * config.num_inference_steps + n * COND_FULL.depth,
            "flash_attention_bwd": VAE_FULL.depth * (n_obj + n_joint),
            "raster_fwd": n_hand + n_obj + 2 * n_joint + n}
    short = {k: (launches[k], v) for k, v in want.items() if launches[k] < v}
    if short:
        fail(f"the batched run launched kernels fewer times than it runs them: {short}")
    shutil.rmtree(root, ignore_errors=True)
    return dict(launches=launches, seconds=stage_s, sampler_seconds=sec, calls=calls,
                dit_rel=rel, peak_gib=peak_gib, per_image_iteration_ms=per_image,
                iteration=iteration, against_run=against_run)

# the photo of the pipeline phase (tools._scene.hoi_photo) and its stage groups, in
# run_pipeline's order: each group's stage modules, whose run() is timed
# the image id of the photo that serve.py's /reconstruct runs (its query.png)
PIPELINE_ID = "query"
PIPELINE_STAGES = (
    ("1-2", ("followmyhold_tpu_torch.preprocess.gemini_objname",
             "followmyhold_tpu_torch.preprocess.get_hunyuan_input")),
    ("3", ("followmyhold_tpu_torch.preprocess.inpaint",)),
    ("4", ("followmyhold_tpu_torch.geometry.moge",)),
    ("5", ("followmyhold_tpu_torch.geometry.hunyuan",)),
    ("6", ("followmyhold_tpu_torch.hand.hamer",)),
    ("7-8", ("followmyhold_tpu_torch.alignment.h2m", "followmyhold_tpu_torch.alignment.mano")),
    ("9", ("followmyhold_tpu_torch.guidance.run",)),
)


class _Tee:
    """A text stream that writes to stdout and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def __getattr__(self, name):     # isatty, encoding, fileno: the stream's
        return getattr(self.stream, name)


@contextlib.contextmanager
def _serving(server):
    """``server`` (serve.make_server) answering in a thread for the block ->
    its base URL; shut down and joined after it."""
    import threading

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_port}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        if thread.is_alive():
            fail("the server's thread did not end")


def _http(url: str, payload=None, timeout: float = 900.0) -> tuple:
    """A GET (without ``payload``) or a JSON POST to the local server ->
    (status, the JSON body, seconds on the host's clock)."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                    timeout=timeout) as r:
            status, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    return status, body, time.perf_counter() - t


def _png_b64(rgb: np.ndarray) -> str:
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def run_pipeline_phase(dev, models) -> dict:
    """The whole pipeline from one photo, as a user of the server runs it: serve.py's
    server on 127.0.0.1 answers POST /reconstruct with tools._scene.hoi_photo
    (1280x960) by main.run_pipeline in a fresh temporary workspace with its own env
    file, stages 1-9 in this process at full width, and returns the two PLYs. Each
    stage's build function hands over models built here or by the earlier phases
    (seeded random weights): stage 3 FLUX.1-Kontext at full width with the synthetic
    vocabularies (built here, freed after stage 3), stage 4 MoGe shaped by
    _shape_moge, stage 6 HaMeR ViT-H, and stages 5 and 9 the main path's Hunyuan
    models, whose field's logit level each build function sets for its own stage on
    the crop stage 2 wrote (stage 5 by _stage5_level's rule on the crop without
    background, stage 9 by _shape_field's on stage 3's output); the level's
    calibration is timed apart. The server's run_pipeline is wrapped: the launch
    counts are set to 0 just before the real run and read just after, and before the
    server removes its workspace the wrapper checks every artifact of the contract,
    the masks non-empty, a finite object PLY and a hand PLY of 778 vertices, and no
    stage reporting an error, then runs run_pipeline again on the same directories,
    which must skip every stage and rewrite no artifact. This thread then checks the
    response (200, both PLYs decoded: a finite object, a 778-vertex hand), the
    wrapper's findings, and every kernel of the path launched. Prints s per image by
    stage and of the whole, the server's own seconds around the run, and the peak
    memory."""
    import base64
    import gc
    import importlib
    import tempfile
    import warnings

    from PIL import Image

    from followmyhold_tpu_torch import main as orchestrator
    from followmyhold_tpu_torch import serve
    from followmyhold_tpu_torch.configs.profiles import (
        crop_size,
        moge_config,
        optimization_config,
    )
    from followmyhold_tpu_torch.diffusion.guidance import GuidedSampler
    from followmyhold_tpu_torch.geometry import hunyuan as hoi
    from followmyhold_tpu_torch.geometry import moge as stage4
    from followmyhold_tpu_torch.geometry.hunyuan import encode_condition
    from followmyhold_tpu_torch.guidance import run as stage9
    from followmyhold_tpu_torch.hand import hamer as hand
    from followmyhold_tpu_torch.models.hunyuan import COND_FULL, DIT_FULL, VAE_FULL
    from followmyhold_tpu_torch.ops import _kernels
    from followmyhold_tpu_torch.preprocess import inpaint as stage3
    from followmyhold_tpu_torch.tools._scene import flux_tokenizer_assets, hoi_photo
    from followmyhold_tpu_torch.utils.artifacts import artifacts_for
    from followmyhold_tpu_torch.utils.mesh_io import load_mesh

    dit, vae, cond = models
    bias = vae.geo.logit.bias.detach().clone()
    t0 = time.perf_counter()
    inpainter = {"models": stage3.build_inpainter(seed=0, device=dev)}
    moge_model = stage4._build_model(moge_config(), seed=0, device=dev)
    hamer_model = hand._build_model(hand._default_config(), device=dev)
    torch.cuda.synchronize()
    say(f"pipeline: built FLUX.1-Kontext + its towers, MoGe and HaMeR at full width in "
        f"{time.perf_counter() - t0:.1f} s")
    handle = _shape_moge(moge_model, dev)
    levels, calibration = {}, {}
    calib_launches = {k: 0 for k in _kernels.launch_counts()}
    # what the run inside the server's request hands back: its configuration,
    # numbers and findings
    run = {}

    @contextlib.contextmanager
    def calibrating(group: str):
        """Time a level calibration and keep its launches apart."""
        before = _kernels.launch_counts()
        t = time.perf_counter()
        yield
        torch.cuda.synchronize()
        calibration[group] = time.perf_counter() - t
        for k, v in _kernels.launch_counts().items():
            calib_launches[k] += v - before[k]

    def learned_inpainter(*a, **k):
        if inpainter["models"] is None:
            fail("stage 3 asked for its models after it had run")
        return inpainter["models"]

    def stage5_models(*a, **k):
        if "5" not in levels:
            crops = run["cfg"].cropped_hoi_wo_bckg_path
            crop = os.path.join(crops, os.listdir(crops)[0])
            with calibrating("5"), torch.no_grad():
                vae.geo.logit.bias.copy_(bias)
                levels["5"] = _stage5_level(dev, models, [(PIPELINE_ID, crop)],
                                            tag="pipeline")["level"]
        with torch.no_grad():
            vae.geo.logit.bias.copy_(bias - levels["5"])
        return models

    def stage9_models(*a, **k):
        if "9" not in levels:
            crops = run["cfg"].cropped_inpainted_obj
            crop = os.path.join(crops, os.listdir(crops)[0])
            with calibrating("9"), torch.no_grad():
                vae.geo.logit.bias.copy_(bias)
                tokens, uncond = encode_condition(
                    cond, np.asarray(Image.open(crop).convert("RGBA")), device=dev)
                levels["9"] = _guidance_level(dev, dit, vae, tokens, uncond, PIPELINE_ID)[0]
            say(f"pipeline: stage 9's field level {levels['9']:.4f} on {os.path.basename(crop)}")
        with torch.no_grad():
            vae.geo.logit.bias.copy_(bias - levels["9"])
        return models

    stage_s, sampler_s = {}, {}
    sampler_run = GuidedSampler.run

    def timed_sampler(self, *a, **k):       # stage 9's sampler and its phases
        t = time.perf_counter()
        result = sampler_run(self, *a, **k)
        torch.cuda.synchronize()
        sampler_s.update(result.seconds, sampler=time.perf_counter() - t)
        return result

    tee = _Tee(sys.stdout)
    real_run = orchestrator.run_pipeline

    def checked_run(cfg, device="cuda"):
        """The server's run_pipeline: the real run, then its checks and a resumed
        second run on the same workspace, before the server removes it. Findings
        go to run["problems"] for the phase's thread to fail on."""
        t_in = time.perf_counter()
        run["cfg"], problems = cfg, run.setdefault("problems", [])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        tee.parts.clear()
        t = time.perf_counter()
        real_run(cfg, device=device)
        torch.cuda.synchronize()
        run["whole_s"] = time.perf_counter() - t
        run["launches"] = {k: v - calib_launches[k]
                           for k, v in _kernels.launch_counts().items()}
        run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        said = "".join(tee.parts)

        art = artifacts_for(cfg, PIPELINE_ID, is_right=True)
        needed = (art.original_img, art.masked_obj_img, art.cropped_hoi,
                  art.cropped_hoi_wo_bckg, art.cropped_obj_mask, art.cropped_hand_mask,
                  art.inpainted_obj, art.moge_fov, art.moge_mesh, art.hunyuan_hoi_mesh,
                  art.hamer_npy, art.hamer_kps, art.hamer_mesh, art.h2m_transform,
                  art.aligned_mano_mesh, art.guidance_obj, art.guidance_hand,
                  os.path.join(cfg.base_dir, "gemini_responses.csv"))
        missing = [os.path.relpath(p, cfg.project_root) for p in needed if not os.path.exists(p)]
        if missing:
            problems.append(f"the pipeline wrote no {missing}")
            return
        if "Error" in said:
            problems.append("a stage of the pipeline reported an error: " + " | ".join(
                line for line in said.splitlines() if "Error" in line))
        shares = run["mask_shares"] = {}
        for mask in (art.cropped_obj_mask, art.cropped_hand_mask):
            m = np.asarray(Image.open(mask)) > 0
            shares[os.path.basename(mask)] = round(float(m.mean()), 4)
            if m.shape != (crop_size(),) * 2 or not m.any():
                problems.append(f"the pipeline's {os.path.basename(mask)} is {m.shape} or empty")
        t_h2m = np.load(art.h2m_transform)
        if not (t_h2m.shape == (4, 4) and np.isfinite(t_h2m).all()):
            problems.append(f"the pipeline's {os.path.basename(art.h2m_transform)} is {t_h2m}")

        # a second run on the same directories skips every stage
        files = sorted(os.path.join(d, f) for d, _, fs in os.walk(cfg.base_dir) for f in fs)
        stamps = {f: os.path.getmtime(f) for f in files if "J_regressor" not in f}
        run["first_s"] = dict(stage_s)
        stage_s.clear()
        tee.parts.clear()
        t = time.perf_counter()
        real_run(cfg, device=device)
        torch.cuda.synchronize()
        run["resume_s"] = time.perf_counter() - t
        said_again = "".join(tee.parts)
        if {f: os.path.getmtime(f) for f in stamps} != stamps or "Error" in said_again:
            problems.append("the second run_pipeline rewrote an artifact or reported an error")
        if said_again.count("skipping") < 8:
            problems.append(f"the second run_pipeline did not skip every stage: "
                            f"{said_again!r}")
        run["wrapper_s"] = time.perf_counter() - t_in

    swaps = [(stage3, "_learned_inpainter", learned_inpainter),
             (GuidedSampler, "run", timed_sampler),
             (stage4, "_build_model", lambda *a, **k: moge_model),
             (hoi, "build_models", stage5_models),
             (hand, "_build_model", lambda *a, **k: hamer_model),
             (stage9, "build_models", stage9_models),
             (orchestrator, "run_pipeline", checked_run)]
    for group, names in PIPELINE_STAGES:
        for name in names:
            module = importlib.import_module(name)
            timed = _timed(module.run, stage_s, group)
            if module is stage3:
                def timed(*a, _run=timed, **k):      # stage 3's models freed after it
                    _run(*a, **k)
                    inpainter["models"] = None
                    gc.collect()
                    torch.cuda.empty_cache()
            swaps.append((module, "run", timed))
    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in swaps]
    photo = hoi_photo()
    try:
        for owner, name, fn in swaps:
            setattr(owner, name, fn)
        # run_pipeline's warning filters (FOHO_SUPPRESS_WARNINGS) end with the phase
        with flux_tokenizer_assets(), contextlib.redirect_stdout(tee), \
                warnings.catch_warnings(), \
                _serving(serve.make_server("127.0.0.1", 0, device=dev)) as url:
            status, body, request_s = _http(url + "/reconstruct", {"image": _png_b64(photo)})
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
        handle.remove()
        with torch.no_grad():
            vae.geo.logit.bias.copy_(bias)
    if status != 200:
        fail(f"POST /reconstruct answered {status}: {body}")
    if run.get("problems"):
        fail("; ".join(run["problems"]))
    if sorted(body) != ["hand_ply", "obj_ply"]:
        fail(f"POST /reconstruct returned {sorted(body)}, not both PLYs")
    root = tempfile.mkdtemp(prefix="fmh_served_")
    meshes = {}
    for key in ("obj_ply", "hand_ply"):
        path = os.path.join(root, f"{key}.ply")
        with open(path, "wb") as f:
            f.write(base64.b64decode(body[key]))
        meshes[key] = load_mesh(path)
    obj, hand_ply = meshes["obj_ply"], meshes["hand_ply"]
    if not (obj.num_faces > 0 and np.isfinite(obj.vertices).all()
            and hand_ply.num_vertices == 778 and np.isfinite(hand_ply.vertices).all()):
        fail(f"the served PLYs: object {obj.num_vertices} verts {obj.num_faces} faces, hand "
             f"{hand_ply.num_vertices} verts, or not finite")
    shutil.rmtree(root, ignore_errors=True)

    whole_s, launches = run["whole_s"], run["launches"]
    config = optimization_config()
    n_hand, n_obj = config.optimization_steps_hand, config.optimization_steps_scale
    n_joint = config.optimization_steps_joint * (config.num_inference_steps
                                                 - config.handopt_start_step - 2)
    # the stages' own seconds: stages 5 and 9 without this script's calibration
    per_stage = {group: sum(run["first_s"].get(group, [0.0])) - calibration.get(group, 0.0)
                 for group, _ in PIPELINE_STAGES}
    calib_s = sum(calibration.values())
    say(f"pipeline: stages 1-9 on one photo {whole_s - calib_s:.2f} s; s per image by stage: "
        + ", ".join(f"{group} {t:.3f}" for group, t in per_stage.items())
        + f" (this script's field-level calibration inside stages 5 and 9, "
        f"{ {g: round(t, 3) for g, t in calibration.items()} } s, is left out); stage 9's "
        f"sampler {sampler_s['sampler']:.2f} s (DiT step median "
        f"{float(np.median(sampler_s['dit_steps'])):.4f} s; hand "
        f"{sampler_s['hand'] / n_hand * 1e3:.2f}, object {sampler_s['obj'] / n_obj * 1e3:.2f}, "
        f"joint {sampler_s['joint'] / n_joint * 1e3:.2f} ms per iteration); peak "
        f"{run['peak_gib']:.2f} GiB; mask shares {run['mask_shares']}; object {obj.num_faces} "
        f"faces; launches {launches}")
    say(f"pipeline: a second run_pipeline on the same directories skipped every stage in "
        f"{run['resume_s']:.3f} s ({ {g: round(sum(t), 3) for g, t in stage_s.items()} })")
    say(f"serve: POST /reconstruct answered 200 in {request_s:.2f} s, {run['wrapper_s']:.2f} s "
        f"of it in the wrapped run_pipeline (the run, its checks and the resumed run): the "
        f"server's own {request_s - run['wrapper_s']:.3f} s (the PNG, the workspace and env "
        f"file, the PLYs in base64, HTTP); object {obj.num_vertices} verts, hand "
        f"{hand_ply.num_vertices} verts")

    n_blocks = DIT_FULL.depth_double + DIT_FULL.depth_single
    want = {"flash_attention_fwd": 57 * 28 + 24 + n_blocks * (30 + config.num_inference_steps)
            + 2 * COND_FULL.depth,
            "flash_attention_bwd": VAE_FULL.depth * (n_obj + n_joint),
            "raster_fwd": n_hand + n_obj + 2 * n_joint + 1,
            "raster_bwd": n_hand + n_obj + 2 * n_joint,
            "raster_chunk_plan": n_hand + n_obj + 2 * n_joint + 1,
            "scatter_rows_add": 2 * (n_hand + n_obj + 2 * n_joint),
            "qk_norm_rope": 76 * 28}
    short = {k: (launches[k], v) for k, v in want.items() if launches[k] < v}
    if short:
        fail(f"the pipeline launched kernels fewer times than its stages run them "
             f"(launched, expected at least): {short}")
    return dict(launches=launches, seconds=whole_s - calib_s, per_stage=per_stage,
                calibration=calibration, sampler=sampler_s, resume_seconds=run["resume_s"],
                peak_gib=run["peak_gib"], levels=levels, request_s=request_s,
                server_s=request_s - run["wrapper_s"])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check the kernels, skip the models")
    args = parser.parse_args()

    t_start = time.perf_counter()
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
               *check_rasterizer(dev), check_qk_norm_rope(dev)]
    launches = launches_entry = launches_mesh = launches_convert = launches_hands = \
        launches_inpaint = launches_hoi = launches_moge = launches_batch = \
        launches_pipeline = {k["name"]: 0 for k in kernels}
    t_models = time.perf_counter()
    if not args.kernels_only:
        entry_run = run_entry_step(dev)
        launches_entry = entry_run["launches"]
        launches_mesh = run_mesh_phase(dev, entry_run)["launches"]
        del entry_run
        launches_convert = run_convert_phase(dev)["launches"]
        detected = run_detect_phase(dev)
        bundle = detected.pop("bundle")
        hands = run_hands_phase(dev, bundle)
        launches_hands = hands["launches"]
        run_serve_phase(dev, bundle)
        del bundle
        gc.collect()
        torch.cuda.empty_cache()
        launches_inpaint = run_inpaint_stage(dev)["launches"]
        ran = run_stage(dev)
        launches, hoi = ran["launches"], ran["hoi"]
        launches_hoi, launches_moge = hoi["launches"], hoi["moge"]["launches"]
        launches_batch = ran["batched"]["launches"]
        attach_raster_overlays(kernels, hoi["raster_overlay"], hands["raster_overlay"])
        launches_pipeline = run_pipeline_phase(dev, ran.pop("models"))["launches"]
        profile_flux_step(dev)
    for k in kernels:
        # launches: the guidance stage's run of one image; launches_entry: entry()'s step;
        # launches_mesh: the mesh phase's ranks (the dry run, the tp step, the dp run);
        # launches_convert: the CFG step of the DiT loaded from its converted file;
        # launches_hands: the multi-hand run of one frame; launches_stage_3, _stage_4,
        # _stages_5_8, _batched and _pipeline: the runs of stage 3, of stage 4, of stages
        # 5-8, of the batched guidance and of run_pipeline's stages 1-9 inside serve.py's
        # POST /reconstruct
        k["launches"] = launches[k["name"]]
        k["launches_entry"] = launches_entry[k["name"]]
        k["launches_mesh"] = launches_mesh[k["name"]]
        k["launches_convert"] = launches_convert[k["name"]]
        k["launches_hands"] = launches_hands[k["name"]]
        k["launches_stage_3"] = launches_inpaint[k["name"]]
        k["launches_stage_4"] = launches_moge[k["name"]]
        k["launches_stages_5_8"] = launches_hoi[k["name"]]
        k["launches_batched"] = launches_batch[k["name"]]
        k["launches_pipeline"] = launches_pipeline[k["name"]]

    now = time.perf_counter()
    say(f"script: {now - t_start:.1f} s in all, {now - t_models:.1f} s of it after the kernel "
        f"checks")
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
