"""Inside/outside tests against a triangle mesh.

Counterpart of followmyhold_tpu/ops/sdf.py; the original pipeline used Kaolin's
check_sign. Only the generalized winding number (Jacobson et al. 2013) is on
the guided sampler's path: the joint phase's intersection count tests 33^3
points against the 1538-face hand mesh, 55 M (point, face) terms, so the
points go in chunks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from followmyhold_tpu_torch.ops.indexing import take_rows


def winding_number(points: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor,
                   face_mask: Optional[torch.Tensor] = None,
                   chunk: int = 4096) -> torch.Tensor:
    """Generalized winding number of [N,3] points with respect to the mesh
    -> [N]: ~0 outside, ~1 inside a consistently wound closed mesh."""
    tri = take_rows(verts, faces)                     # [F,3,3]
    out = []
    for p in points.split(chunk):
        a = tri[:, 0][None] - p[:, None]              # [n,F,3]
        b = tri[:, 1][None] - p[:, None]
        c = tri[:, 2][None] - p[:, None]
        la = torch.linalg.norm(a, dim=-1)
        lb = torch.linalg.norm(b, dim=-1)
        lc = torch.linalg.norm(c, dim=-1)
        det = torch.sum(a * torch.linalg.cross(b, c, dim=-1), dim=-1)
        denom = (la * lb * lc
                 + torch.sum(a * b, dim=-1) * lc
                 + torch.sum(b * c, dim=-1) * la
                 + torch.sum(c * a, dim=-1) * lb)
        omega = 2.0 * torch.atan2(det, denom)         # solid angle per face
        if face_mask is not None:
            omega = omega * face_mask[None].to(omega.dtype)
        out.append(torch.sum(omega, dim=-1) / (4.0 * math.pi))
    return torch.cat(out)
