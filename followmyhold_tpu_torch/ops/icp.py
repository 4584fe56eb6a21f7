"""ICP with a similarity Procrustes step.

Counterpart of followmyhold_tpu/ops/icp.py:
- correspondences: each source point's nearest target point (``ops.knn``);
- the step: a weighted Umeyama similarity fit through a 3x3 SVD, with the
  determinant's sign fixed so that no reflection is fitted;
- outlier rejection: the worst ``outliers`` share of the correspondences is
  weighted out in every iteration, and the cost is the mean inlier distance;
- the scale clamped to [min_scale, max_scale] in every iteration;
- the transform of the lowest cost kept, optionally over restarts from the
  axis-aligned rotations and reflections (a loop over them).

The loop keeps everything on the device and reads nothing back, except that
``torch.linalg.svd`` of the 3x3 covariance may synchronise with the host on
CUDA (``chip_smoke.py`` counts the synchronisations an iteration).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from followmyhold_tpu_torch.ops.knn import nn_sqdist
from followmyhold_tpu_torch.ops.precision import matmul_f32


def procrustes(p: torch.Tensor, q: torch.Tensor, weights: Optional[torch.Tensor] = None,
               scale: bool = True) -> torch.Tensor:
    """The 4x4 similarity T minimising sum_i w_i ||T(p_i) - q_i||^2 (Umeyama,
    no reflection); p, q [N,3]."""
    p, q = p.float(), q.float()
    if weights is None:
        weights = torch.ones(p.shape[0], dtype=torch.float32, device=p.device)
    w = weights / weights.sum().clamp(min=1e-12)
    mu_p = torch.sum(p * w[:, None], dim=0)
    mu_q = torch.sum(q * w[:, None], dim=0)
    pc, qc = p - mu_p, q - mu_q
    cov = matmul_f32((qc * w[:, None]).t(), pc)                 # [3,3]
    u, s, vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
    r = matmul_f32(u * diag[None, :], vt)
    if scale:
        var_p = torch.sum(w * torch.sum(pc * pc, dim=-1))
        s_fit = torch.sum(s * diag) / var_p.clamp(min=1e-12)
    else:
        s_fit = torch.ones((), dtype=torch.float32, device=p.device)
    t = mu_q - s_fit * matmul_f32(r, mu_p[:, None])[:, 0]
    T = torch.eye(4, dtype=torch.float32, device=p.device)
    T[:3, :3] = s_fit * r
    T[:3, 3] = t
    return T


def _apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return matmul_f32(pts, T[:3, :3].t()) + T[:3, 3]


def _clamp_scale(T: torch.Tensor, min_scale: float, max_scale: float) -> torch.Tensor:
    s = torch.linalg.norm(T[:3, 0])
    out = T.clone()
    out[:3, :3] = T[:3, :3] / s.clamp(min=1e-12) * s.clamp(min_scale, max_scale)
    return out


class IcpResult(NamedTuple):
    transform: torch.Tensor   # [4,4]
    cost: torch.Tensor        # scalar


def _run_one(source: torch.Tensor, target: torch.Tensor, init: torch.Tensor, n_iter: int,
             n_outliers: int, fixed_scale: bool, min_scale: float,
             max_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    n_inliers = source.shape[0] - n_outliers
    transform, best_T = init, init
    best_cost = torch.full((), float("inf"), dtype=torch.float32, device=source.device)
    for _ in range(n_iter):
        p = _apply(transform, source)
        d2, qi = nn_sqdist(p, target)
        dist = torch.sqrt(d2)
        q = target[qi]
        if n_outliers > 0:
            # weight out the worst n_outliers; the cost over the inliers
            thresh = torch.sort(dist).values[n_inliers - 1]
            w = (dist <= thresh).float()
            cost = torch.sum(dist * w) / w.sum().clamp(min=1.0)
        else:
            w = torch.ones_like(dist)
            cost = dist.mean()
        transform = matmul_f32(procrustes(p, q, weights=w, scale=not fixed_scale), transform)
        if not fixed_scale:
            transform = _clamp_scale(transform, min_scale, max_scale)
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best_T = torch.where(better, transform, best_T)
    return best_T, best_cost


def icp(
    source_points: torch.Tensor,
    target_points: torch.Tensor,
    n_iter: int,
    init_transforms: Optional[torch.Tensor] = None,
    outliers: float = 0.0,
    fixed_scale: bool = False,
    min_scale: float = 0.5,
    max_scale: float = 2.0,
) -> IcpResult:
    """ICP from each init transform [C,4,4] (default: the identity) of the
    source points [N,3] onto the target points [M,3]; the best transform and
    its cost. Runs where the points lie."""
    source, target = source_points.float(), target_points.float()
    if init_transforms is None:
        init_transforms = torch.eye(4, dtype=torch.float32)[None]
    init_transforms = init_transforms.to(source.device, torch.float32)
    n_outliers = int(outliers * source.shape[0])
    results = [_run_one(source, target, cube, n_iter, n_outliers, fixed_scale, min_scale,
                        max_scale) for cube in init_transforms]
    if len(results) == 1:
        return IcpResult(*results[0])
    transforms = torch.stack([t for t, _ in results])
    costs = torch.stack([c for _, c in results])
    best = torch.argmin(costs)
    return IcpResult(transforms[best], costs[best])


def axis_aligned_restarts(include_identity: bool = True, rotations: bool = True,
                          reflections: bool = True) -> np.ndarray:
    """The restart transforms: the identity, 7 reflections, 9 rotations of
    -90, 180 and 90 degrees about each axis -> [C,4,4] float32."""
    cubes = []
    if include_identity:
        cubes.append(np.eye(4))
    if reflections:
        for diag in ([1, 1, -1], [1, -1, 1], [-1, 1, 1], [-1, -1, 1],
                     [-1, 1, -1], [1, -1, -1], [-1, -1, -1]):
            cubes.append(np.eye(4) * np.append(diag, 1))
    if rotations:
        for coord in range(3):
            axis = np.zeros(3)
            axis[coord] = 1
            for angle in (-np.pi / 2, np.pi, np.pi / 2):
                c, s = np.cos(angle), np.sin(angle)
                K = np.array([[0, -axis[2], axis[1]],
                              [axis[2], 0, -axis[0]],
                              [-axis[1], axis[0], 0]])
                T = np.eye(4)
                T[:3, :3] = np.eye(3) + s * K + (1 - c) * (K @ K)
                cubes.append(T)
    return np.stack(cubes).astype(np.float32)


def compute_init_transform(source_points: np.ndarray, target_points: np.ndarray,
                           fixed_scale: bool = False) -> np.ndarray:
    """The centroids' translation and the bounding-box diagonals' ratio as
    the scale (about the source centroid) -> [4,4] float32."""
    sc = source_points.mean(axis=0)
    tc = target_points.mean(axis=0)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = tc - sc
    if fixed_scale:
        return T
    s_scale = np.linalg.norm(source_points.max(axis=0) - source_points.min(axis=0))
    t_scale = np.linalg.norm(target_points.max(axis=0) - target_points.min(axis=0))
    scale = float(t_scale / max(s_scale, 1e-12))
    S = np.eye(4, dtype=np.float32)
    S[:3, :3] *= scale
    S[:3, 3] = sc - scale * sc
    return T @ S


def sample_surface(verts: np.ndarray, faces: np.ndarray, count: int,
                   seed: int = 0) -> np.ndarray:
    """``count`` points uniform over the surface (faces drawn by area), on the
    host, with the reference's numpy draws in its order -> [count, 3] float32."""
    rng = np.random.default_rng(seed)
    tri = verts[faces]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    total = area.sum()
    if total <= 0:
        idx = rng.integers(0, len(faces), count)
    else:
        idx = rng.choice(len(faces), size=count, p=area / total)
    u = rng.random((count, 1))
    v = rng.random((count, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    t = tri[idx]
    return (t[:, 0] + u * (t[:, 1] - t[:, 0]) + v * (t[:, 2] - t[:, 0])).astype(np.float32)
