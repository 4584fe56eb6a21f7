"""MANO hand model data and keypoints.

Counterpart of followmyhold_tpu/models/mano.py, as far as the guided sampler
needs it: the model container, the deterministic synthetic stand-in with the
real structure (778 verts / 16 joints / 1538 faces), and the keypoint readout
from an already-posed mesh. Linear blend skinning is not on the sampler's path
and is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from followmyhold_tpu_torch.ops.precision import matmul_f32
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device

NUM_VERTS = 778
NUM_JOINTS = 16
NUM_BETAS = 10

# smplx vertex_ids['mano']: thumb, index, middle, ring, pinky fingertips.
FINGERTIP_VERTEX_IDS = (744, 320, 443, 554, 671)

# 16 regressed + 5 fingertips -> OpenPose 21 ordering.
MANO_TO_OPENPOSE = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)


class ManoModel(NamedTuple):
    v_template: torch.Tensor    # [778, 3]
    shapedirs: torch.Tensor     # [778, 3, 10]
    posedirs: torch.Tensor      # [135, 778*3] (pose-blend basis, smplx layout)
    j_regressor: torch.Tensor   # [16, 778]
    lbs_weights: torch.Tensor   # [778, 16]
    faces: torch.Tensor         # [1538, 3] int64


def synthetic_mano(seed: int = 0, device: DeviceLike = "cuda") -> ManoModel:
    """Deterministic hand-shaped stand-in with real MANO structure.

    Gaussian blobs around a palm and five finger chains, random face triples,
    a gaussian joint regressor and skinning weights. The numbers are drawn with
    numpy in the same order as the reference, so both packages get the same
    model from the same seed.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    finger_dirs = np.array(
        [[1.0, 0.25, 0], [1.0, 0.1, 0], [1.0, -0.05, 0], [1.0, -0.2, 0],
         [0.7, 0.45, 0.1]], np.float32)
    finger_dirs /= np.linalg.norm(finger_dirs, axis=-1, keepdims=True)
    joints = [np.zeros(3, np.float32)]
    for fd in finger_dirs:
        base = fd * 0.09
        for seg in range(3):
            joints.append((base + fd * 0.025 * (seg + 1)).astype(np.float32))
    joints = np.stack(joints)  # [16,3]

    verts = []
    counts = [178] + [120] * 5
    centers = [np.zeros(3)] + [joints[1 + 3 * i + 1] for i in range(5)]
    spreads = [0.05] + [0.035] * 5
    for c, n, sp in zip(centers, counts, spreads):
        verts.append(c + rng.normal(scale=sp, size=(n, 3)))
    verts = np.concatenate(verts).astype(np.float32)[:NUM_VERTS]

    tri = rng.integers(0, NUM_VERTS, size=(1538, 3)).astype(np.int32)
    bad = (tri[:, 0] == tri[:, 1]) | (tri[:, 1] == tri[:, 2]) | (tri[:, 0] == tri[:, 2])
    tri[bad] = np.array([[0, 1, 2]], np.int32)

    d = np.linalg.norm(verts[None] - joints[:, None], axis=-1)  # [16,778]
    jr = np.exp(-(d ** 2) / (2 * 0.02 ** 2))
    jr /= jr.sum(axis=1, keepdims=True)

    w = np.exp(-(d.T ** 2) / (2 * 0.03 ** 2)) + 1e-6  # [778,16]
    w /= w.sum(axis=1, keepdims=True)

    shapedirs = rng.normal(scale=1e-3, size=(NUM_VERTS, 3, NUM_BETAS)).astype(np.float32)
    posedirs = rng.normal(scale=1e-4, size=(135, NUM_VERTS * 3)).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return ManoModel(
        v_template=t(verts),
        shapedirs=t(shapedirs),
        posedirs=t(posedirs),
        j_regressor=t(jr.astype(np.float32)),
        lbs_weights=t(w.astype(np.float32)),
        faces=t(tri.astype(np.int64)),
    )


def mano_vert_to_3dkps(verts: torch.Tensor, j_regressor16: torch.Tensor) -> torch.Tensor:
    """Keypoints from an already-posed MANO mesh: 16 regressed joints + 5
    fingertip verts, OpenPose order. verts [778,3]; j_regressor16 [16,778]."""
    regressed = matmul_f32(j_regressor16, verts)
    tips = verts[list(FINGERTIP_VERTEX_IDS)]
    kps = torch.cat([regressed, tips], dim=0)
    return kps[list(MANO_TO_OPENPOSE)]
