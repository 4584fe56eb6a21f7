"""The guidance renderer's camera.

Counterpart of ``GuidanceCamera`` in followmyhold_tpu/ops/camera.py. The
reference pipeline builds a PyTorch3D FoV camera with R = 180 degrees about y
and T = 0 over meshes in GL convention (x right, y up, z toward the viewer).
Composing that camera's NDC and screen transforms collapses to an OpenCV
pinhole on the flipped point (x, -y, -z):

    u = cx + f * x / (-z),   v = cy + f * (-y) / (-z)

with f = (S-1)/2 / tan(fov/2), cx = (W-1)/2, cy = (H-1)/2, and camera-space
depth z_cam = -z.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch

FovLike = Optional[Union[float, torch.Tensor]]


@dataclass(frozen=True)
class GuidanceCamera:
    """fov_deg is the horizontal field of view; znear/zfar bound the depth test."""

    height: int
    width: int
    fov_deg: float
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def focal_px(self) -> float:
        # PyTorch3D's screen mapping uses (S-1)/2 half-extents.
        return (min(self.height, self.width) - 1) / 2.0 / math.tan(
            math.radians(self.fov_deg) / 2.0)

    def _focal(self, fov_deg: FovLike):
        """focal_px for a per-image fov override (float or 0-d tensor)."""
        if fov_deg is None:
            return self.focal_px
        half = torch.deg2rad(torch.as_tensor(fov_deg, dtype=torch.float32)) / 2.0
        return (min(self.height, self.width) - 1) / 2.0 / torch.tan(half)

    def to_camera_space(self, points: torch.Tensor) -> torch.Tensor:
        """GL-convention world points -> OpenCV camera coords (z>0 forward)."""
        return points * points.new_tensor([1.0, -1.0, -1.0])

    def project(self, points: torch.Tensor, fov_deg: FovLike = None) -> torch.Tensor:
        """World points [..., 3] -> (u, v, depth) [..., 3].

        (u, v) in pixels (origin top-left, v down); depth is camera-space z,
        clamped at 1e-6 only inside the division.
        """
        cam = self.to_camera_space(points)
        z = cam[..., 2].clamp(min=1e-6)
        f = self._focal(fov_deg)
        if isinstance(f, torch.Tensor):
            f = f.to(points.device)
        u = (self.width - 1) / 2.0 + f * cam[..., 0] / z
        v = (self.height - 1) / 2.0 + f * cam[..., 1] / z
        return torch.stack([u, v, cam[..., 2]], dim=-1)
