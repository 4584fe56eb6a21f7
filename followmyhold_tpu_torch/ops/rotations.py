"""Rotation representations: quaternion (wxyz), axis-angle and 6d rotation
to and from rotation matrices.

Counterpart of followmyhold_tpu/ops/rotations.py, ported whole. Every
function is batched over leading dimensions and differentiable. The 6d
packing is HaMeR's: the first two columns of the matrix, stored one after
the other.
"""

from __future__ import annotations

import torch

from followmyhold_tpu_torch.ops.safe import safe_normalize


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion(s) [..., 4] -> rotation matrix [..., 3, 3].

    Normalizes first: guidance optimizes raw quaternions, so they drift off
    the unit sphere.
    """
    quat = safe_normalize(quat)
    w, x, y, z = quat.unbind(-1)
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, dim=-2)


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> wxyz quaternion [..., 4] with w >= 0.

    Branch-free (Shepperd): all four candidate quaternions are formed and the
    best-conditioned one, the one of the largest diagonal term, is kept.
    """
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                      1 - m00 + m11 - m22, 1 - m00 - m11 + m22], dim=-1).clamp(min=1e-12)
    q = torch.sqrt(qw) * 0.5
    q0, q1, q2, q3 = q.unbind(-1)
    cand = torch.stack([
        torch.stack([q0, (m21 - m12) / (4 * q0), (m02 - m20) / (4 * q0),
                     (m10 - m01) / (4 * q0)], -1),
        torch.stack([(m21 - m12) / (4 * q1), q1, (m01 + m10) / (4 * q1),
                     (m02 + m20) / (4 * q1)], -1),
        torch.stack([(m02 - m20) / (4 * q2), (m01 + m10) / (4 * q2), q2,
                     (m12 + m21) / (4 * q2)], -1),
        torch.stack([(m10 - m01) / (4 * q3), (m02 + m20) / (4 * q3),
                     (m12 + m21) / (4 * q3), q3], -1),
    ], dim=-2)                                               # [..., 4 candidates, 4]
    best = qw.argmax(dim=-1)
    quat = torch.take_along_dim(cand, best[..., None, None].expand(*best.shape, 1, 4),
                                dim=-2)[..., 0, :]
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    return quat * torch.where(quat[..., :1] < 0, -1.0, 1.0)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> wxyz quaternion [..., 4], exact and
    differentiable at the zero angle (a series there)."""
    sq = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    small = sq < 1e-12
    # the double where keeps the square root's gradient finite at zero
    angle = torch.where(small, torch.zeros_like(sq), torch.sqrt(torch.where(small, 1.0, sq)))
    half = angle * 0.5
    k = torch.where(small, 0.5 - sq / 48.0,
                    torch.sin(half) / torch.where(small, torch.ones_like(angle), angle))
    return torch.cat([torch.cos(half), axis_angle * k], dim=-1)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix, through the quaternion (tighter
    in float32 than Rodrigues' form)."""
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def quaternion_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w = quat[..., :1].clamp(-1.0, 1.0)
    xyz = quat[..., 1:]
    norm = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    angle = 2 * torch.atan2(norm, w)
    small = norm < 1e-8
    axis = xyz / torch.where(small, torch.ones_like(norm), norm)
    return torch.where(small, torch.zeros_like(xyz), axis * angle)


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def rot6d_to_matrix(rot6d: torch.Tensor) -> torch.Tensor:
    """6d rotation [..., 6] -> matrix [..., 3, 3] (Zhou et al. 2019).

    HaMeR's packing: a1 = x[0:3], a2 = x[3:6] are the first two columns;
    Gram-Schmidt gives b1, b2, and b3 = b1 x b2. The tiny identity offsets
    take a degenerate input (a zero-initialised head) toward the identity
    instead of NaN.
    """
    a = rot6d.reshape(*rot6d.shape[:-1], 2, 3)
    a1, a2 = a[..., 0, :], a[..., 1, :]
    eye = torch.eye(3, dtype=rot6d.dtype, device=rot6d.device)
    a1 = a1 + eye[0] * 1e-6
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp(min=1e-8)
    proj = torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2 - proj + eye[1] * 1e-6
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp(min=1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def matrix_to_rot6d(matrix: torch.Tensor) -> torch.Tensor:
    """The inverse packing of ``rot6d_to_matrix``: [column 1, column 2]."""
    return torch.cat([matrix[..., :, 0], matrix[..., :, 1]], dim=-1)
