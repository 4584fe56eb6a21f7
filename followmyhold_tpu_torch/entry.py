"""An entry into the port for a harness: one CFG denoise step of the flagship DiT.

Counterpart of ``__graft_entry__.entry()`` at the repository's root:
``entry()`` returns ``(fn, args)``, and ``fn(*args)`` runs the Hunyuan3D-2
DiT (seeded random weights, ``DIT_FULL`` by default) at batch 2 on [1, 3072,
64] latents and 1,370 condition tokens (the DINOv2-G grid and its cls
token), takes the classifier-free guidance at scale 5.0 and advances the
latents by one step of the 20-step flow-matching schedule. At full width that
step runs the flash-attention forward at [2, 16, 4442, 128], once in each of
the 24 blocks. The reference's multi-device dry run waits for the port's
device mesh.

    python -c "from followmyhold_tpu_torch.entry import entry; fn, a = entry(); fn(*a)"
"""

from __future__ import annotations

import numpy as np
import torch

from followmyhold_tpu_torch.diffusion.scheduler import make_schedule, step
from followmyhold_tpu_torch.models.hunyuan import DIT_FULL, DiTConfig, HunyuanDiT
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device
from followmyhold_tpu_torch.utils.params import init_random_

NUM_LATENTS = 3072
COND_TOKENS = 1370       # DINOv2-G's 37x37 grid and its cls token
GUIDANCE_SCALE = 5.0


def entry(cfg: DiTConfig = DIT_FULL, device: DeviceLike = "cuda"):
    """(fn, (dit, latents, cond, step_index)): one CFG denoise step."""
    dev = resolve_device(device)
    dit = init_random_(HunyuanDiT(cfg, device=dev), seed=2).eval().requires_grad_(False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    latents = torch.randn((1, NUM_LATENTS, cfg.in_channels), generator=gen, device=dev)
    cond = torch.randn((2, COND_TOKENS, cfg.context_dim), generator=gen,
                       device=dev).to(torch.bfloat16)
    sched = make_schedule(sigmas=np.linspace(0, 1, 20))

    @torch.no_grad()
    def denoise_step(dit: HunyuanDiT, latents: torch.Tensor, cond: torch.Tensor,
                     i: int) -> torch.Tensor:
        t = np.float32(sched.timesteps[i]) / np.float32(sched.num_train_timesteps)
        lat_in = torch.cat([latents, latents], dim=0)
        tt = torch.full((2,), float(t), dtype=latents.dtype, device=latents.device)
        eps = dit(lat_in, tt, cond)
        eps_c, eps_u = eps.chunk(2, dim=0)
        eps_cfg = eps_u + GUIDANCE_SCALE * (eps_c - eps_u)
        new_latents, _ = step(sched, i, eps_cfg, latents)
        return new_latents

    return denoise_step, (dit, latents, cond, 0)
