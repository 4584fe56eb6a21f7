"""The ranks of test_torch_parallel.py's two-rank run, in a module of their own
so that a spawned interpreter imports torch and the port only (not JAX).

``tp_dp_rank`` joins a gloo group through a file, then, on the CPU:

- tp=2: shards the tiny DiT and ShapeVAE (``shard_model_params``), keeps every
  split layer's local weight and bias, and runs the DiT forward and the
  ShapeVAE decode with the gradient of a scalar loss with respect to its
  latents, beside the same calls of unsharded copies; and a DiT of three
  heads, whose attention layers are split alone, forward and backward;
- dp=2: ``GuidedSampler.run_batch(mesh=)`` on two images, and rank 0 also
  runs it without a mesh.

Each rank writes what it found to ``rank{r}.pt`` in the output directory.
"""

from __future__ import annotations

import copy
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from followmyhold_tpu_torch.configs.guidance import OptimizationConfig
from followmyhold_tpu_torch.diffusion.guidance import GuidedSampler
from followmyhold_tpu_torch.entry import DRYRUN_SIZE, dryrun_configs, dryrun_inputs, dryrun_targets
from followmyhold_tpu_torch.models import hunyuan as H
from followmyhold_tpu_torch.ops.camera import GuidanceCamera
from followmyhold_tpu_torch.parallel.mesh import (
    ColumnParallelLinear,
    RowParallelLinear,
    make_mesh,
    shard_model_params,
    tp_plan,
)
from followmyhold_tpu_torch.utils.params import init_random_

# the dp run's sampler: every phase once (hand at step 1, object at 2, joint at
# 3); the joint phase's intersection count (winding numbers of a 32^3 grid, the
# most of a CPU iteration) is left out
DP_CONFIG = dict(num_inference_steps=4, optimization_steps_hand=1,
                 optimization_steps_scale=1, optimization_steps_joint=1,
                 octree_resolution=8, use_intersection_loss=False)


def _models(weights, dit_cfg, vae_cfg):
    dit, vae = H.HunyuanDiT(dit_cfg), H.ShapeVAE(vae_cfg)
    dit.load_state_dict(weights[0])
    vae.load_state_dict(weights[1])
    return dit.eval().requires_grad_(False), vae.eval().requires_grad_(False)


def _split_layers(module):
    return {name: (("col" if isinstance(sub, ColumnParallelLinear) else "row"),
                   sub.weight.detach().clone(),
                   None if sub.bias is None else sub.bias.detach().clone())
            for name, sub in module.named_modules()
            if isinstance(sub, (ColumnParallelLinear, RowParallelLinear))}


def _decode_and_grad(vae, latents, queries):
    z = latents.clone().requires_grad_(True)
    logits = H.vae_query_logits(vae, z, queries, chunk=64)
    (logits.square().mean() + logits.sum()).backward()
    return logits.detach(), z.grad


def _forward_and_grad(dit, lat, t, cond):
    x = lat.clone().requires_grad_(True)
    y = dit(x, t, cond)
    y.square().mean().backward()
    return y.detach(), x.grad


def tp_dp_rank(rank: int, world: int, init_file: str, out_dir: str, weights) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        out = {"rank": rank}
        dit_cfg, vae_cfg, _, sampler_kw = dryrun_configs()
        rng = np.random.default_rng(7)

        # ---- tp=2 ------------------------------------------------------------ #
        tp_mesh = make_mesh("tp=2", device_type="cpu", backend="gloo")
        dit, vae = _models(weights, dit_cfg, vae_cfg)
        sdit, svae = _models(weights, dit_cfg, vae_cfg)
        shard_model_params(sdit, tp_mesh)
        shard_model_params(svae, tp_mesh)
        out["split"] = {**{f"dit.{k}": v for k, v in _split_layers(sdit).items()},
                        **{f"vae.{k}": v for k, v in _split_layers(svae).items()}}
        out["local_heads"] = dict(
            double=sdit.double_blocks[0].heads, single=sdit.single_blocks[0].heads,
            single_hidden=sdit.single_blocks[0].hidden, vae=svae.decoder.blocks[0].heads,
            geo=svae.geo.heads)
        lat = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32))
        t = torch.tensor([0.3, 0.7])
        cond = torch.from_numpy(rng.standard_normal((2, 4, 32)).astype(np.float32))
        with torch.no_grad():
            out["dit"] = (dit(lat, t, cond), sdit(lat, t, cond))
        z = torch.from_numpy(rng.standard_normal((1, 16, 8)).astype(np.float32))
        q = torch.from_numpy(rng.uniform(-1, 1, (1, 300, 3)).astype(np.float32))
        out["vae"] = (_decode_and_grad(vae, z, q), _decode_and_grad(svae, z, q))

        # three heads do not divide over tp=2: the attention's kernels are split
        # alone (the fused projection's output gathered, the input of the
        # projection after it sliced), the MLPs' in pairs
        odd_cfg = dataclasses.replace(dit_cfg, hidden=48, heads=3, depth_single=1)
        odd = init_random_(H.HunyuanDiT(odd_cfg), seed=4).eval().requires_grad_(False)
        sodd = copy.deepcopy(odd)
        shard_model_params(sodd, tp_mesh)
        out["odd_split"] = sorted(n for n, (_, _, paired) in tp_plan(odd, 2).items()
                                  if not paired)
        out["odd"] = tuple(_forward_and_grad(m, lat, t, cond) for m in (odd, sodd))

        # ---- dp=2 ------------------------------------------------------------ #
        dp_mesh = make_mesh("dp=2", device_type="cpu", backend="gloo")
        sampler = GuidedSampler(
            dit=dit, vae=vae, config=OptimizationConfig(**DP_CONFIG),
            camera=GuidanceCamera(height=DRYRUN_SIZE, width=DRYRUN_SIZE, fov_deg=60.0),
            **sampler_kw)
        x = dryrun_inputs(2, seed=5)
        targets = [dryrun_targets(x, b, "cpu") for b in range(2)]
        cond_main = torch.from_numpy(np.ascontiguousarray(x["cond_cat"][:, :1]))   # [2,1,4,32]
        uncond = torch.from_numpy(np.ascontiguousarray(x["cond_cat"][:, 1:]))
        noise = torch.from_numpy(x["noise"])
        args = (cond_main, uncond, targets, (16, 8))
        out["dp"] = sampler.run_batch(*args, initial_noise=noise, device="cpu", mesh=dp_mesh)
        if rank == 0:
            out["dp_ref"] = sampler.run_batch(*args, initial_noise=noise, device="cpu")
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
