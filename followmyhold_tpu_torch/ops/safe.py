"""NaN-safe differentiable norms.

sqrt(sum(x^2)) has a NaN gradient at x = 0, and a `where` guard after the sqrt
does not block it (0 * NaN = NaN in the chain rule). The double-where pattern
evaluates sqrt only on a safe operand, so both value and gradient are clean at
zero. Padded mesh buffers make zero-length vectors routine here, so every
differentiated norm in the port goes through these.
"""

from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    small = sq < eps
    root = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    return torch.where(small, torch.zeros_like(sq), root)


def safe_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    small = sq < eps
    inv = 1.0 / torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    return x * torch.where(small, torch.zeros_like(sq), inv)
