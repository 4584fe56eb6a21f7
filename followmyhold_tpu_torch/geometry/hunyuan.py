"""Model construction for the Hunyuan shape stage.

Counterpart of ``build_models`` in followmyhold_tpu/geometry/hunyuan.py. No
checkpoint exists offline, so the models carry seeded random weights, as the
reference's do without a checkpoint. The image conditioner is not ported yet:
callers supply condition tokens.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from followmyhold_tpu_torch.models.hunyuan import (
    DIT_FULL,
    VAE_FULL,
    DiTConfig,
    HunyuanDiT,
    ShapeVAE,
    ShapeVAEConfig,
)
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device
from followmyhold_tpu_torch.utils.params import init_random_


def build_models(dit_cfg: Optional[DiTConfig] = None,
                 vae_cfg: Optional[ShapeVAEConfig] = None,
                 seed: int = 0,
                 device: DeviceLike = "cuda") -> Tuple[HunyuanDiT, ShapeVAE]:
    """(dit, vae) on ``device`` with seeded random weights, in eval mode and
    with gradients to the weights off (the sampler optimizes poses and noise,
    never weights). Defaults are the full-size configurations."""
    dev = resolve_device(device)
    dit = HunyuanDiT(dit_cfg or DIT_FULL, device=dev)
    vae = ShapeVAE(vae_cfg or VAE_FULL, device=dev)
    init_random_(dit, seed)
    init_random_(vae, seed + 1)
    for model in (dit, vae):
        model.eval().requires_grad_(False)
    return dit, vae
