"""The Hunyuan HOI mesh stage (un-guided shape generation), and the model
construction and image conditioning that the guidance stage shares.

Counterpart of followmyhold_tpu/geometry/hunyuan.py. ``run`` takes every HOI
crop ({id}_cropped_hoi_*.png, pure white as transparent) through the plain
flow-matching pipeline (30 CFG steps) in batches of up to 5 images, each with
its own noise stream, then each image through the 384^3 export, floater and
degenerate-face removal and face reduction, to {id}_hoi_mesh.ply. The models
load their converted checkpoints where the files exist and carry seeded
random weights where they do not, as the reference's do
(``build_models``). ``FOHO_TPU_PROFILE=tiny`` picks the reference's tiny
configurations where no configuration is given.

    python -m followmyhold_tpu_torch.geometry.hunyuan --image_dir ... --save_dir ... \
        [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from followmyhold_tpu_torch.configs.profiles import hunyuan_octree_resolution, is_tiny
from followmyhold_tpu_torch.diffusion.pipeline import denoise_latents, latents_to_mesh
from followmyhold_tpu_torch.geometry.postprocess import (
    reduce_faces,
    remove_degenerate_faces,
    remove_floaters,
)
from followmyhold_tpu_torch.models.hunyuan import (
    COND_FULL,
    COND_TINY,
    DIT_FULL,
    VAE_FULL,
    VAE_TINY,
    Conditioner,
    ConditionerConfig,
    DiTConfig,
    HunyuanDiT,
    ShapeVAE,
    ShapeVAEConfig,
)
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device
from followmyhold_tpu_torch.utils.mesh_io import write_ply
from followmyhold_tpu_torch.utils.params import (
    init_random_,
    load_or_init,
    scheduler_shift as _ckpt_shift,
)
from followmyhold_tpu_torch.utils.prng import SEED_HUNYUAN, stage_generator

# images per batch of the denoising loop, as the reference batches them
BATCH = 5

# the reference's tiny DiT: conditioned on COND_TINY's width, on VAE_TINY's latents
DIT_PROFILE_TINY = DiTConfig(in_channels=VAE_TINY.embed_dim, hidden=64, heads=4,
                             depth_double=1, depth_single=1,
                             context_dim=COND_TINY.embed_dim, time_dim=32,
                             dtype=torch.float32)


def build_models(dit_cfg: Optional[DiTConfig] = None,
                 vae_cfg: Optional[ShapeVAEConfig] = None,
                 cond_cfg: Optional[ConditionerConfig] = None,
                 seed: int = 0,
                 device: DeviceLike = "cuda") -> Tuple[HunyuanDiT, ShapeVAE, Conditioner]:
    """(dit, vae, conditioner) on ``device``, in eval mode and with gradients
    to the weights off (the sampler optimizes poses and noise, never
    weights). Each model loads its converted checkpoint (``hunyuan_dit``,
    ``hunyuan_vae``, ``hunyuan_cond`` under ``<assets>/params/``) where the
    file exists, as the reference does, and carries seeded random weights
    where it does not (the conditioner's unconditional embedding then zeros,
    as in the original model). The port's ``convert.hunyuan`` writes
    ``hunyuan_cond``; the JAX converter writes ``hunyuan_conditioner``, which
    neither package reads. A configuration not given is the full-size
    one, or the tiny one under ``FOHO_TPU_PROFILE=tiny``."""
    dev = resolve_device(device)
    tiny = is_tiny()

    def init_cond(cond: Conditioner) -> None:
        init_random_(cond, seed + 2)
        with torch.no_grad():
            cond.uncond_embedding.zero_()

    dit = load_or_init("hunyuan_dit",
                       HunyuanDiT(dit_cfg or (DIT_PROFILE_TINY if tiny else DIT_FULL), device=dev),
                       lambda m: init_random_(m, seed))
    vae = load_or_init("hunyuan_vae",
                       ShapeVAE(vae_cfg or (VAE_TINY if tiny else VAE_FULL), device=dev),
                       lambda m: init_random_(m, seed + 1))
    cond = load_or_init("hunyuan_cond",
                        Conditioner(cond_cfg or (COND_TINY if tiny else COND_FULL), device=dev),
                        init_cond)
    for model in (dit, vae, cond):
        model.eval().requires_grad_(False)
    return dit, vae, cond


@torch.no_grad()
def encode_condition(cond: Conditioner, image_rgba: np.ndarray,
                     device: DeviceLike = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """RGBA image [H,W,4] uint8 -> (cond_main, uncond_main) token pairs
    [1, n_tokens, width] on ``device``; the conditioner must lie there."""
    dev = resolve_device(device)
    rgb = torch.from_numpy(np.ascontiguousarray(image_rgba[..., :3])).to(dev).float() / 255.0
    tokens = cond(rgb[None])["main"]
    uncond = cond.unconditional_embedding(1)["main"]
    return tokens, uncond


def white_to_alpha(image_rgb: np.ndarray) -> np.ndarray:
    """RGB [H,W,3] uint8 -> RGBA with the pure-white pixels transparent."""
    white = np.all(image_rgb == 255, axis=-1)
    alpha = np.where(white, 0, 255).astype(np.uint8)
    return np.concatenate([image_rgb, alpha[..., None]], axis=-1)


def run(
    image_dir: str,
    save_dir: str,
    num_inference_steps: int = 30,
    octree_resolution: Optional[int] = None,
    guidance_scale: float = 7.5,
    project_root: Optional[str] = None,      # CLI parity
    scheduler_shift: Optional[float] = None,  # None: the checkpoint's scheduler config
    models: Optional[Tuple[HunyuanDiT, ShapeVAE, Conditioner]] = None,
    initial_noise: Optional[Dict[str, torch.Tensor]] = None,
    device: DeviceLike = "cuda",
) -> None:
    """Every image of ``image_dir`` to {id}_hoi_mesh.ply in ``save_dir``; an
    image whose mesh exists is skipped. ``models`` is ``build_models()``'s
    (dit, vae, conditioner) on ``device``; ``initial_noise`` maps an image id
    to its initial latents [1, L, E], in place of the stage generator's draw
    (to hold the port against another run)."""
    dev = resolve_device(device)
    if scheduler_shift is None:
        scheduler_shift = _ckpt_shift()
    if octree_resolution is None:
        octree_resolution = hunyuan_octree_resolution()
    os.makedirs(save_dir, exist_ok=True)
    dit, vae, cond = models if models is not None else build_models(device=dev)

    images = sorted(glob.glob(os.path.join(image_dir, "*.png"))
                    + glob.glob(os.path.join(image_dir, "*.jpg")))
    if not images:
        print(f"No images found in {image_dir}")
        return
    pending = []
    for img_path in images:
        image_id = os.path.basename(img_path).split("_")[0]
        out_path = os.path.join(save_dir, f"{image_id}_hoi_mesh.ply")
        if os.path.exists(out_path):
            print(f"{image_id} exists, skipping")
            continue
        pending.append((img_path, image_id, out_path))

    latent_shape = (vae.cfg.num_latents, vae.cfg.embed_dim)
    for i in range(0, len(pending), BATCH):
        group = pending[i:i + BATCH]
        conds, unconds, noise = [], [], []
        for img_path, image_id, _ in group:
            rgba = white_to_alpha(np.asarray(Image.open(img_path).convert("RGB")))
            cm, um = encode_condition(cond, rgba, device=dev)
            conds.append(cm[0])
            unconds.append(um[0])
            if initial_noise is not None and image_id in initial_noise:
                noise.append(initial_noise[image_id].to(dev, torch.float32).reshape(
                    1, *latent_shape))
            else:
                # one stream per image: an image's mesh does not depend on its batch
                gen = stage_generator(SEED_HUNYUAN, "hunyuan", image_id, dev)
                noise.append(torch.randn((1, *latent_shape), generator=gen, device=dev))
        latents = denoise_latents(
            dit, torch.stack(conds), torch.stack(unconds), latent_shape,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            initial_noise=torch.cat(noise), scheduler_shift=scheduler_shift, device=dev)

        for b, (_, image_id, out_path) in enumerate(group):
            mesh = latents_to_mesh(vae, latents[b:b + 1], octree_resolution=octree_resolution,
                                   box_v=1.01, max_verts=196608, max_faces=393216, device=dev)
            nv, nf = mesh.num_verts, mesh.num_faces
            verts = mesh.verts[:nv].cpu().numpy()
            faces = mesh.faces[:nf].cpu().numpy().astype(np.int32)
            verts, faces = remove_floaters(verts, faces)
            verts, faces = remove_degenerate_faces(verts, faces)
            verts, faces = reduce_faces(verts, faces)
            write_ply(out_path, verts, faces)
            print(f"Exported {out_path} ({len(verts)} verts, {len(faces)} faces)")


def main() -> None:
    parser = argparse.ArgumentParser(description="Hunyuan HOI mesh, un-guided")
    parser.add_argument("--image_dir", required=True)
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--project_root", default=None)
    parser.add_argument("--num_inference_steps", type=int, default=30)
    parser.add_argument("--scheduler_shift", type=float, default=None,
                        help="override the checkpoint scheduler_config shift")
    parser.add_argument("--octree_resolution", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    run(args.image_dir, args.save_dir, args.num_inference_steps, args.octree_resolution,
        project_root=args.project_root, scheduler_shift=args.scheduler_shift,
        device=args.device)


if __name__ == "__main__":
    main()
