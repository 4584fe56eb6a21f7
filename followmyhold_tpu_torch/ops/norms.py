"""GroupNorm in float32 over large feature maps.

Shared by MoGe's neck and heads (``models/moge.py``) and the FLUX VAE
(``models/flux.py``). The moments are one reduction over each (image, group)
flattened: ``F.group_norm`` takes one block per (image, group), so the
GroupNorm(1) of a 960x960x32 map ran in one block (583 of a 641-ms MoGe
forward on one H100 80GB HBM3 at 700 W, tools/profile_moge.py), and the FLUX
decoder's last level, [1,128,512,512] in 32 groups, would run on 32 blocks.
"""

from __future__ import annotations

import torch
from torch import nn

# Flax's GroupNorm epsilon (torch's default is 1e-5)
FLAX_GN_EPS = 1e-6


def group_norm_f32(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """``norm`` of an NC... map in float32 with Flax's epsilon; the result is
    float32, as Flax's ``GroupNorm(dtype=float32)`` returns it."""
    B, C = x.shape[:2]
    grouped = x.float().reshape(B, norm.num_groups, -1)
    var, mean = torch.var_mean(grouped, dim=-1, correction=0, keepdim=True)
    y = ((grouped - mean) * torch.rsqrt(var + FLAX_GN_EPS)).reshape(x.shape)
    affine = (1, C) + (1,) * (x.dim() - 2)
    return y * norm.weight.reshape(affine) + norm.bias.reshape(affine)
