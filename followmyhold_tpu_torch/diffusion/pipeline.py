"""Plain flow-matching shape sampling: CFG double-batch DiT forwards over the
reversed-sigma schedule, then VAE grid decode -> (negated) SDF -> marching-tets
mesh. Counterpart of followmyhold_tpu/diffusion/pipeline.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from followmyhold_tpu_torch.diffusion.scheduler import make_schedule, step
from followmyhold_tpu_torch.models.hunyuan import (
    HunyuanDiT,
    ShapeVAE,
    hierarchical_export_logits,
    vae_query_logits,
)
from followmyhold_tpu_torch.ops.grid import generate_dense_grid_points
from followmyhold_tpu_torch.ops.surface import (
    PaddedMesh,
    marching_tets,
    marching_tets_host,
    surface_capacity_counts,
)
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device


@torch.no_grad()
def cfg_noise_pred(dit: HunyuanDiT, cond_cat: torch.Tensor, latents: torch.Tensor,
                   t: float, guidance_scale: float) -> torch.Tensor:
    """One classifier-free-guidance DiT evaluation. cond_cat is
    [cond; uncond] stacked on the batch axis, latents [B,L,E]."""
    lat_in = torch.cat([latents, latents], dim=0)
    tt = torch.full((lat_in.shape[0],), t, dtype=latents.dtype, device=latents.device)
    eps_c, eps_u = dit(lat_in, tt, cond_cat).chunk(2, dim=0)
    return eps_u + guidance_scale * (eps_c - eps_u)


@torch.no_grad()
def denoise_latents(
    dit: HunyuanDiT,
    cond_main: torch.Tensor,      # [B, M, C]
    uncond_main: torch.Tensor,    # [B, M, C]
    latent_shape: Tuple[int, int],
    num_inference_steps: int = 30,
    guidance_scale: float = 7.5,
    initial_noise: Optional[torch.Tensor] = None,  # [B, *latent_shape]
    generator: Optional[torch.Generator] = None,
    scheduler_shift: float = 1.0,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """The CFG sampling loop. The initial latents are ``initial_noise`` or
    drawn from ``generator`` on the device."""
    dev = resolve_device(device)
    B = cond_main.shape[0]
    sched = make_schedule(sigmas=np.linspace(0, 1, num_inference_steps),
                          shift=scheduler_shift)
    if initial_noise is not None:
        latents = initial_noise.to(dev, torch.float32)
    else:
        latents = torch.randn((B, *latent_shape), generator=generator, device=dev)
    cond_cat = torch.cat([cond_main, uncond_main], dim=0).to(dev)
    for i in range(num_inference_steps):
        t = sched.timesteps[i] / sched.num_train_timesteps
        eps = cfg_noise_pred(dit, cond_cat, latents, t, guidance_scale)
        latents, _ = step(sched, i, eps, latents)
    return latents


def latents_to_mesh(
    vae: ShapeVAE,
    latents: torch.Tensor,        # [1, L, E]
    octree_resolution: int = 64,
    box_v: float = 1.10,
    max_verts: int = 32768,
    max_faces: int = 65536,
    chunk: int = 8192,
    device_res_limit: int = 256,
    device: DeviceLike = "cuda",
) -> PaddedMesh:
    """VAE grid decode -> negated logits -> surface (sdf = -logits, so inside
    < 0). Up to ``device_res_limit`` the extraction runs on the device into
    static capacities, and the true pre-truncation counts are checked so that
    overruns warn. Above it (the 384^3 export) the two-level decode runs on
    the device and an exact-shape extraction on the host."""
    dev = resolve_device(device)
    latents = latents.to(dev)
    if octree_resolution > device_res_limit:
        sdf = -hierarchical_export_logits(vae, latents, box_v, octree_resolution, chunk=chunk)
        hv, hf = marching_tets_host(sdf, [-box_v] * 3, [box_v] * 3, octree_resolution)
        verts = torch.from_numpy(hv if len(hv) else np.zeros((1, 3), np.float32)).to(dev)
        faces = torch.from_numpy(hf if len(hf) else np.zeros((1, 3), np.int32)).to(dev).long()
        return PaddedMesh(verts=verts, faces=faces,
                          vert_mask=torch.full((verts.shape[0],), float(len(hv) > 0), device=dev),
                          face_mask=torch.full((faces.shape[0],), float(len(hf) > 0), device=dev))
    xyz, _, _ = generate_dense_grid_points([-box_v] * 3, [box_v] * 3, octree_resolution,
                                           device=dev)
    sdf = -vae_query_logits(vae, latents, xyz[None], chunk)[0]
    mesh = marching_tets(sdf, [-box_v] * 3, [box_v] * 3, octree_resolution,
                         max_verts=max_verts, max_faces=max_faces)
    check_surface_capacity(sdf, octree_resolution, max_verts, max_faces)
    return mesh


def check_surface_capacity(sdf: torch.Tensor, resolution: int,
                           max_verts: int, max_faces: int) -> None:
    """Warn when the true surface exceeds the padded-buffer capacities
    (overflow drops geometry silently otherwise)."""
    na, nf = surface_capacity_counts(sdf, resolution)
    if na > max_verts or nf > max_faces:
        print(f"WARNING: marching_tets capacity overflow: "
              f"{na}/{max_verts} verts, {nf}/{max_faces} faces — "
              f"geometry was truncated; raise max_verts/max_faces")
