"""Precision policy: geometry in full float32, networks in bfloat16.

A float32 matrix product on an NVIDIA card may run through the tensor cores in
TF32, which keeps about three decimal digits: enough for a network, not for a
rotation or a projection. PyTorch leaves TF32 off for matrix products by
default; this module states and sets it, so the geometry layer does not depend
on a default or on what another library set before. Importing it is what sets
the flag; every geometry module of the port imports it.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product in float32 (TF32 off, see above)."""
    return torch.matmul(a.float(), b.float())
