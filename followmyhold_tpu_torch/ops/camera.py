"""Cameras and projection.

Counterpart of followmyhold_tpu/ops/camera.py. Two camera models:

1. ``perspective_projection``, HaMeR's OpenCV pinhole, and
   ``cam_crop_to_full``, which takes HaMeR's weak-perspective crop camera to a
   translation in the full image.

2. ``GuidanceCamera``, the guidance renderer's camera. The reference
   pipeline builds a PyTorch3D FoV camera with R = 180 degrees about y and
   T = 0 over meshes in GL convention (x right, y up, z toward the viewer).
   Composing that camera's NDC and screen transforms collapses to an OpenCV
   pinhole on the flipped point (x, -y, -z):

       u = cx + f * x / (-z),   v = cy + f * (-y) / (-z)

   with f = (S-1)/2 / tan(fov/2), cx = (W-1)/2, cy = (H-1)/2, and
   camera-space depth z_cam = -z.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch

FovLike = Optional[Union[float, torch.Tensor]]


def perspective_projection(
    points: torch.Tensor,
    translation: torch.Tensor,
    focal_length: torch.Tensor,
    camera_center: Optional[torch.Tensor] = None,
    rotation: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """OpenCV pinhole projection of [B, N, 3] points -> [B, N, 2] pixels;
    translation [B, 3], focal_length [B, 2], camera_center [B, 2], rotation
    [B, 3, 3]."""
    points = points.float()
    if rotation is not None:
        points = torch.einsum("bij,bkj->bki", rotation.float(), points)
    points = points + translation[:, None, :]
    uv = points[..., :2] / points[..., 2:3] * focal_length[:, None, :]
    if camera_center is not None:
        uv = uv + camera_center[:, None, :]
    return uv


def cam_crop_to_full(
    cam_bbox: torch.Tensor,
    box_center: torch.Tensor,
    box_size: torch.Tensor,
    img_size: torch.Tensor,
    focal_length: float = 5000.0,
) -> torch.Tensor:
    """Weak-perspective crop camera (s, tx, ty) [B, 3] -> translation [B, 3]
    in the full image; box_center [B, 2], box_size [B], img_size [B, 2] as
    (width, height)."""
    img_w, img_h = img_size[:, 0], img_size[:, 1]
    cx, cy, b = box_center[:, 0], box_center[:, 1], box_size
    bs = b * cam_bbox[:, 0] + 1e-9
    tz = 2.0 * focal_length / bs
    tx = (2.0 * (cx - img_w / 2.0) / bs) + cam_bbox[:, 1]
    ty = (2.0 * (cy - img_h / 2.0) / bs) + cam_bbox[:, 2]
    return torch.stack([tx, ty, tz], dim=-1)


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
        clamped at 1e-6 only inside the division. A ``fov_deg`` of shape [B]
        gives each image of points [B, ..., 3] its own field of view.
        """
        cam = self.to_camera_space(points)
        z = cam[..., 2].clamp(min=1e-6)
        f = self._focal(fov_deg)
        if isinstance(f, torch.Tensor):
            f = f.to(points.device)
            if f.dim() == 1:
                f = f.reshape(-1, *([1] * (points.dim() - 2)))
        u = (self.width - 1) / 2.0 + f * cam[..., 0] / z
        v = (self.height - 1) / 2.0 + f * cam[..., 1] / z
        return torch.stack([u, v, cam[..., 2]], dim=-1)
