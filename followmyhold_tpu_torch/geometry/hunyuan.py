"""Model construction and image conditioning for the Hunyuan shape stage.

Counterpart of ``build_models`` and ``encode_condition`` in
followmyhold_tpu/geometry/hunyuan.py. No checkpoint exists offline, so the
models carry seeded random weights, as the reference's do without a
checkpoint. ``FOHO_TPU_PROFILE=tiny`` picks the reference's tiny
configurations where no configuration is given.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from followmyhold_tpu_torch.configs.profiles import is_tiny
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
from followmyhold_tpu_torch.utils.params import init_random_

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
    """(dit, vae, conditioner) on ``device`` with seeded random weights, in
    eval mode and with gradients to the weights off (the sampler optimizes
    poses and noise, never weights). A configuration not given is the
    full-size one, or the tiny one under ``FOHO_TPU_PROFILE=tiny``."""
    dev = resolve_device(device)
    tiny = is_tiny()
    dit = HunyuanDiT(dit_cfg or (DIT_PROFILE_TINY if tiny else DIT_FULL), device=dev)
    vae = ShapeVAE(vae_cfg or (VAE_TINY if tiny else VAE_FULL), device=dev)
    cond = Conditioner(cond_cfg or (COND_TINY if tiny else COND_FULL), device=dev)
    init_random_(dit, seed)
    init_random_(vae, seed + 1)
    init_random_(cond, seed + 2)
    with torch.no_grad():
        cond.uncond_embedding.zero_()   # zeros, as in the original model
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
