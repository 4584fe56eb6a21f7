"""The synthetic hand scene the GPU tools share: the synthetic MANO mesh a
third of the image wide in front of a 60-degree camera, with random targets."""

from __future__ import annotations

import numpy as np
import torch

from followmyhold_tpu_torch.diffusion.guidance import GuidanceTargets
from followmyhold_tpu_torch.models.mano import synthetic_mano
from followmyhold_tpu_torch.ops.camera import GuidanceCamera


def hand_scene(dev, size: int = 512):
    """(mano, verts [778,3], camera, targets) on ``dev``."""
    mano = synthetic_mano(device=dev)
    verts = mano.v_template - mano.v_template.mean(0) + torch.tensor([0.0, 0.0, -0.8], device=dev)
    camera = GuidanceCamera(height=size, width=size, fov_deg=60.0)
    rng = np.random.default_rng(0)
    s = size / 512.0
    hand_mask = torch.zeros((size, size), dtype=torch.bool)
    hand_mask[int(160 * s):int(320 * s), int(160 * s):int(320 * s)] = True
    obj_mask = torch.zeros((size, size), dtype=torch.bool)
    obj_mask[int(240 * s):int(400 * s), int(240 * s):int(400 * s)] = True
    t_h2m = torch.eye(4)
    t_h2m[:3, :3] *= 0.25
    t_h2m[2, 3] = -0.8
    targets = GuidanceTargets(
        mano_verts_moge=verts, mano_faces=mano.faces, j_regressor=mano.j_regressor,
        hamer_2d_kps=torch.from_numpy(rng.uniform(80 * s, 432 * s, (21, 2)).astype(np.float32)),
        moge_normal=torch.from_numpy(rng.uniform(0, 1, (size, size, 3)).astype(np.float32)),
        moge_disp=torch.from_numpy(rng.uniform(0, 1, (size, size)).astype(np.float32)),
        hand_mask=hand_mask, obj_mask=obj_mask, t_h2m=t_h2m).to(dev)
    return mano, verts, camera, targets
