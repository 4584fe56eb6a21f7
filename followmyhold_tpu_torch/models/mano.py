"""MANO hand model: data, linear blend skinning and keypoints.

Counterpart of followmyhold_tpu/models/mano.py: the model container, the
loader of the official MANO_RIGHT.pkl (with a tolerant unpickler, so chumpy
need not be installed), the deterministic synthetic stand-in with the real
structure (778 verts / 16 joints / 1538 faces) that the loader falls back to,
the LBS forward that HaMeR poses its hand with (pose as rotation matrices,
smplx's ``batch_rigid_transform`` along the kinematic chain), and the
keypoint readout from an already-posed mesh. The sums run in float32 in the
reference's order: each einsum as there, the chain in ``PARENTS`` order.
"""

from __future__ import annotations

import io
import os
import pickle
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from followmyhold_tpu_torch.ops.indexing import image_rows, scatter_rows_add
from followmyhold_tpu_torch.ops.precision import matmul_f32
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device

NUM_VERTS = 778
NUM_JOINTS = 16
NUM_BETAS = 10

# MANO kinematic tree (wrist, then index/middle/pinky/ring/thumb chains).
PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)

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


class ManoOutput(NamedTuple):
    vertices: torch.Tensor      # [B, 778, 3]
    joints: torch.Tensor        # [B, 21, 3] OpenPose order


class _ChumpyStub:
    """Stands in for chumpy's arrays when the official pickle is read."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy") or module == "scipy.sparse.csc":
            if name in ("Ch", "ch"):
                return _ChumpyStub
        return super().find_class(module, name)


def _to_np(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    for attr in ("r", "x", "data"):
        v = getattr(x, attr, None)
        if isinstance(v, np.ndarray):
            return v
    if hasattr(x, "toarray"):
        return x.toarray()
    d = getattr(x, "__dict__", {})
    for attr in ("x", "r", "a"):
        if attr in d and isinstance(d[attr], np.ndarray):
            return d[attr]
    raise TypeError(f"Cannot convert {type(x)} to ndarray")


def load_mano(path: Optional[str] = None, device: DeviceLike = "cuda") -> ManoModel:
    """MANO_RIGHT.pkl in the official layout (default: under the assets root),
    or ``synthetic_mano`` when the file does not exist."""
    dev = resolve_device(device)
    if path is None:
        from followmyhold_tpu_torch.configs.paths import assets_root

        path = os.path.join(assets_root(), "mano", "MANO_RIGHT.pkl")
    if not os.path.exists(path):
        return synthetic_mano(device=dev)
    with open(path, "rb") as f:
        data = _TolerantUnpickler(io.BytesIO(f.read()), encoding="latin1").load()
    shapedirs = _to_np(data["shapedirs"]).astype(np.float32)[..., :NUM_BETAS]
    # smplx keeps posedirs as [V,3,P] and reshapes them to [P, V*3]
    posedirs = _to_np(data["posedirs"]).astype(np.float32).reshape(NUM_VERTS * 3, -1).T

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype))).to(dev)

    return ManoModel(
        v_template=t(_to_np(data["v_template"])),
        shapedirs=t(shapedirs),
        posedirs=t(posedirs),
        j_regressor=t(_to_np(data["J_regressor"])),
        lbs_weights=t(_to_np(data["weights"])),
        faces=t(_to_np(data["f"]), np.int64),
    )


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


def _rigid_transforms(rot_mats: torch.Tensor,
                      joints: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics: rot_mats [B,16,3,3], rest joints [B,16,3] ->
    (posed joints [B,16,3], transforms relative to the rest pose [B,16,4,4])."""
    B = rot_mats.shape[0]
    rel_joints = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, list(PARENTS[1:])]], dim=1)
    last_row = rot_mats.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(B, NUM_JOINTS, 1, 4)
    local = torch.cat([torch.cat([rot_mats, rel_joints[..., None]], dim=-1), last_row], dim=-2)
    world = [local[:, 0]]
    for i in range(1, NUM_JOINTS):
        world.append(matmul_f32(world[PARENTS[i]], local[:, i]))
    world = torch.stack(world, dim=1)                                    # [B,16,4,4]
    posed_joints = world[:, :, :3, 3]
    # take out the rest pose: A = T - pack(T @ [j, 0])
    joints_h = torch.cat([joints, joints.new_zeros(B, NUM_JOINTS, 1)], dim=-1)
    correction = torch.einsum("bjik,bjk->bji", world, joints_h.float())
    rel = world.clone()
    rel[:, :, :3, 3] = world[:, :, :3, 3] - correction[..., :3]
    return posed_joints, rel


def mano_forward(
    model: ManoModel,
    global_orient: torch.Tensor,       # [B,1,3,3] or [B,3,3]
    hand_pose: torch.Tensor,           # [B,15,3,3]
    betas: torch.Tensor,               # [B,10]
    transl: Optional[torch.Tensor] = None,
) -> ManoOutput:
    """Posed vertices and the 21 OpenPose keypoints (the 16 posed joints and
    the 5 fingertip vertices), in float32."""
    if global_orient.dim() == 3:
        global_orient = global_orient[:, None]
    global_orient, hand_pose, betas = global_orient.float(), hand_pose.float(), betas.float()
    B = betas.shape[0]
    rot_mats = torch.cat([global_orient, hand_pose], dim=1)              # [B,16,3,3]

    v_shaped = model.v_template + torch.einsum("bl,vcl->bvc", betas, model.shapedirs)
    joints = torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped)
    # pose blend shapes from (R - I) of the 15 hand joints
    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (hand_pose - eye).reshape(B, -1)                      # [B,135]
    v_posed = v_shaped + torch.einsum("bp,pn->bn", pose_feature,
                                      model.posedirs).reshape(B, NUM_VERTS, 3)

    posed_joints, rel = _rigid_transforms(rot_mats, joints)
    T = torch.einsum("vj,bjrc->bvrc", model.lbs_weights, rel)             # [B,V,4,4]
    v_h = torch.cat([v_posed, v_posed.new_ones(B, NUM_VERTS, 1)], dim=-1)
    verts = torch.einsum("bvrc,bvc->bvr", T, v_h)[..., :3]

    tips = verts[:, list(FINGERTIP_VERTEX_IDS)]
    joints21 = torch.cat([posed_joints, tips], dim=1)[:, list(MANO_TO_OPENPOSE)]
    if transl is not None:
        verts = verts + transl[:, None]
        joints21 = joints21 + transl[:, None]
    return ManoOutput(vertices=verts, joints=joints21)


def mano_vert_to_3dkps(verts: torch.Tensor, j_regressor16: torch.Tensor) -> torch.Tensor:
    """Keypoints from an already-posed MANO mesh: 16 regressed joints + 5
    fingertip verts, OpenPose order. verts [778,3]; j_regressor16 [16,778];
    or a batch, [B,778,3] and [B,16,778] -> [B,21,3].

    Each joint is the sum of its 778 weighted vertices through
    ``scatter_rows_add`` (fixed point on the card), so that each image's
    keypoints and their gradient do not depend on the batch, as a batched
    matrix product's would there; one mesh is a batch of one."""
    if verts.dim() == 2:
        return mano_vert_to_3dkps(verts[None], j_regressor16[None])[0]
    B, V = verts.shape[:2]
    terms = j_regressor16.float()[..., None] * verts.float()[:, None]     # [B,16,V,3]
    regressed = scatter_rows_add(B * 16, image_rows(B * 16, V, verts.device),
                                 terms.reshape(-1, 3)).reshape(B, 16, 3)
    tips = verts[..., list(FINGERTIP_VERTEX_IDS), :]
    kps = torch.cat([regressed, tips], dim=-2)
    return kps[..., list(MANO_TO_OPENPOSE), :]
