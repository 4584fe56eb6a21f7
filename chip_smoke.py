#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py               # everything (what a checkout is judged by)
    python3 chip_smoke.py --kernels-only  # build + kernel checks, no models

Phases, each printing one line; any failure ends the run with a non-zero code:

1. device   require CUDA; print the card's name and power limit.
2. build    compile the CUDA kernels from followmyhold_tpu_torch/csrc with nvcc.
3. kernels  call every kernel's wrapper at the shapes the main path gives it
            and hold the result against its plain PyTorch version on the same
            inputs; time kernel, plain version and, for attention, PyTorch's
            scaled_dot_product_attention as a yardstick (the port never calls it).
4. main     full-width Hunyuan3D-2 DiT + ShapeVAE with seeded random weights:
            GuidedSampler.run (20 CFG steps, 200 hand-pose Adam steps through
            render and losses, scheduler advance) and export_meshes at 64^3.
            The kernels' launch counts are set to 0 just before and read just
            after.
5. result   a `kernels` JSON line, the nvidia-smi line, and the `ok` JSON line.

Tolerances, and why:
- flash attention O (bf16): 1e-2 * max|ref| + 1e-3. The kernel rounds the
  unnormalised probabilities to bf16 before the second product and divides by
  the row sum afterwards; the plain version normalises first. Both then round
  O to bf16 (relative 2^-8).
- flash attention logsumexp (f32): 2e-3 absolute: exp2/log in another order
  and f32 sums over up to 4442 columns.
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

def check_flash_attention(dev) -> dict:
    from followmyhold_tpu_torch.ops import attention as A

    shapes = [  # (label, B, H, N, M, D)
        ("dit_joint", 2, 16, 4442, 4442, 128),
        ("vae_self", 1, 16, 3072, 3072, 64),
        ("geo_cross", 4, 16, 8192, 3072, 64),
    ]
    per_shape = []
    for label, B, H, N, M, D in shapes:
        gen = torch.Generator(device=dev).manual_seed(N + D)
        q = (torch.randn((B, H, N, D), generator=gen, device=dev) * 2.0).bfloat16()
        k = torch.randn((B, H, M, D), generator=gen, device=dev).bfloat16()
        v = torch.randn((B, H, M, D), generator=gen, device=dev).bfloat16()
        scale = 1.0 / math.sqrt(D)
        with torch.no_grad():
            out, lse = A.flash_attention_forward(q, k, v, scale)
            torch.cuda.synchronize()
            ref, ref_lse = A.flash_attention_plain(q, k, v, scale)
            err_o = (out.float() - ref.float()).abs().max().item()
            err_l = (lse - ref_lse).abs().max().item()
            tol_o = 1e-2 * ref.float().abs().max().item() + 1e-3
            if not (math.isfinite(err_o) and err_o <= tol_o):
                fail(f"flash attention {label}: O differs by {err_o} (tolerance {tol_o})")
            if not (math.isfinite(err_l) and err_l <= 2e-3):
                fail(f"flash attention {label}: logsumexp differs by {err_l} (tolerance 2e-3)")
            ms = cuda_ms(lambda: A.flash_attention_forward(q, k, v, scale), 2, 10)
            plain_ms = cuda_ms(lambda: A.flash_attention_plain(q, k, v, scale), 1, 2)
            lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=scale), 2, 10)
        flops = 4.0 * B * H * N * M * D
        nbytes = 2.0 * B * H * D * (2 * N + 2 * M) + 4.0 * B * H * N
        t_ops, t_bytes = flops / _BF16_FLOPS * 1e3, nbytes / _HBM_BYTES * 1e3
        per_shape.append(dict(
            shape=label, dims=[B, H, N, M, D], max_abs_err=err_o, lse_max_abs_err=err_l,
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            tflops=flops / ms / 1e9))
        say(f"kernel flash_attention_fwd {label} {[B, H, N, M, D]}: err_O {err_o:.3e} "
            f"err_lse {err_l:.3e} kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
            f"sdpa {lib_ms:.3f} ms bound {max(t_ops, t_bytes):.3f} ms")
        del q, k, v, out, lse, ref, ref_lse
        torch.cuda.empty_cache()
    head = per_shape[0]  # the DiT's joint attention: most launches on the main path
    return dict(name="flash_attention_fwd", route="cuda",
                source="followmyhold_tpu_torch/csrc/flash_attention_fwd.cu",
                replaces="followmyhold_tpu/ops/attention.py:108",
                max_abs_err=max(s["max_abs_err"] for s in per_shape),
                ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"], shapes=per_shape)


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
    bin_ms = cuda_ms(lambda: _tile_inputs(camera, obj_verts, sphere.faces[:nf], 24576), 1, 5)
    obj_bound, _, _ = _raster_bound(tile_start_o, _RASTER_FWD_OPS, 36, 16)
    say(f"kernel raster_fwd object 512^2 F={nf} P={geom_o.shape[1]}: err {err_o:.3e} slot "
        f"mismatch {mismatch_o:.2e} kernel {obj_ms:.3f} ms bound {obj_bound:.4f} ms; "
        f"projecting, binning and packing it (torch ops) {bin_ms:.3f} ms")

    fwd = dict(name="raster_fwd", route="cuda",
               source="followmyhold_tpu_torch/csrc/raster_fwd.cu",
               replaces="followmyhold_tpu/ops/rasterizer.py:506",
               max_abs_err=max(err_f, err_o), ms=fwd_ms, plain_ms=plain_fwd_ms,
               bound_ms=fwd_bound, bound_by=fwd_by, library_ms=None,
               pixel_face_pairs=pairs, slot_mismatch=max(mismatch, mismatch_o),
               object_mesh=dict(faces=nf, ms=obj_ms, bound_ms=obj_bound, bin_and_pack_ms=bin_ms))
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

def run_main_path(dev) -> dict:
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

    config = OptimizationConfig(optimization_steps_scale=0, optimization_steps_joint=0)
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

    n_steps, n_hand = config.num_inference_steps, config.optimization_steps_hand
    n_blocks = DIT_FULL.depth_double + DIT_FULL.depth_single
    curve = result.losses["hand"].float().cpu()
    nv, nf = obj_mesh.num_verts, obj_mesh.num_faces
    dit_s = result.seconds["dit_steps"]
    say(f"main: run {run_s:.2f} s (DiT step median {float(np.median(dit_s)):.4f} s, first "
        f"{dit_s[0]:.4f} s; hand phase {result.seconds['hand']:.2f} s = "
        f"{result.seconds['hand'] / n_hand * 1e3:.2f} ms/iteration), export {export_s:.2f} s, "
        f"peak memory {peak_gb:.2f} GiB")
    say(f"main: hand loss first {curve[0].item():.5f} last {curve[-1].item():.5f} min "
        f"{curve.min().item():.5f}; object mesh {nv} verts {nf} faces; launches {launches}")

    if curve.numel() != n_hand or not torch.isfinite(curve).all():
        fail("hand loss curve is incomplete or not finite")
    if not curve[-1].item() < curve[0].item():
        fail(f"hand loss did not decrease: {curve[0].item()} -> {curve[-1].item()}")
    if not all(torch.isfinite(x).all() for x in (result.latents, *result.hand, hand_verts)):
        fail("non-finite latents or hand pose")
    if tuple(result.latents.shape) != (1, VAE_FULL.num_latents, VAE_FULL.embed_dim):
        fail(f"latents have shape {tuple(result.latents.shape)}")
    if nv <= 0 or nf <= 0 or not torch.isfinite(obj_mesh.verts).all():
        fail(f"exported object mesh is empty or not finite ({nv} verts, {nf} faces)")
    if launches["flash_attention_fwd"] < n_blocks * n_steps:
        fail(f"flash attention launched {launches['flash_attention_fwd']} times, expected at "
             f"least {n_blocks * n_steps}")
    if launches["raster_fwd"] < n_hand or launches["raster_bwd"] < n_hand:
        fail(f"rasterizer launched {launches['raster_fwd']} / {launches['raster_bwd']} times, "
             f"expected at least {n_hand} each")
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
    _kernels.load_library(verbose=True)
    say(f"build: kernels compiled and loaded in {time.perf_counter() - t0:.1f} s")

    kernels = [check_flash_attention(dev), *check_rasterizer(dev)]
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
