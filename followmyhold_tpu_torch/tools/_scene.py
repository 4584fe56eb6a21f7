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


def moge_grid_mesh(rows: int, cols: int, size: int, fov_deg: float, seed: int = 0):
    """An image-grid mesh as MoGe exports it: one vertex per grid sample
    spread over the whole image, back-projected at a smooth depth (0.6-1.0 in
    front of the camera, GL convention), two faces per grid cell.
    -> (verts [rows*cols, 3] float32, faces [2*(rows-1)*(cols-1), 3] int32)."""
    cam = GuidanceCamera(height=size, width=size, fov_deg=fov_deg)
    f = cam.focal_px
    rng = np.random.default_rng(seed)
    v, u = np.meshgrid(np.linspace(0, size - 1, rows), np.linspace(0, size - 1, cols),
                       indexing="ij")
    a, b = rng.uniform(2, 5, 2)
    depth = 0.8 + 0.15 * np.sin(a * u / size) * np.cos(b * v / size)
    x = (u - (size - 1) / 2.0) * depth / f
    y = -(v - (size - 1) / 2.0) * depth / f
    verts = np.stack([x, y, -depth], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(rows * cols).reshape(rows, cols)
    a0, a1 = idx[:-1, :-1].reshape(-1), idx[:-1, 1:].reshape(-1)
    b0, b1 = idx[1:, :-1].reshape(-1), idx[1:, 1:].reshape(-1)
    faces = np.concatenate([np.stack([a0, b0, a1], -1), np.stack([a1, b0, b1], -1)])
    return verts, faces.astype(np.int32)


def moge_scene(height: int, width: int, fov_deg: float = 60.0, z_shift: float = 1.5):
    """A point map as MoGe predicts one for an HOI crop, and its mask
    probability: an object 1 m in front of a tilted background 3 m away,
    seen at ``fov_deg`` horizontally, with a strip of invalid pixels along
    the top. Its z is shifted by ``-z_shift`` (MoGe's points are known up to
    a z shift), so that ``recover_focal_shift`` has a shift and a focal to
    find: z_shift and the focal of ``fov_deg``. Random weights give a point
    map without either (its focal fit has a flat cost); the GPU smoke run and
    the MoGe parity tests blend this scene into the head outputs.
    -> (points [H,W,3] float32, mask probability [H,W] float32)."""
    from followmyhold_tpu_torch.models.moge import normalized_view_plane_uv

    aspect = width / height
    uv = normalized_view_plane_uv(height, width).numpy().astype(np.float64)
    u, v = uv[..., 0], uv[..., 1]
    focal = aspect / (1 + aspect ** 2) ** 0.5 / np.tan(np.radians(fov_deg) / 2)
    depth = 3.0 + 0.4 * v
    box = (np.abs(u) < 0.2) & (np.abs(v - 0.05) < 0.25)
    depth = np.where(box, 2.0 + 0.3 * u, depth)
    points = np.stack([u * depth / focal, v * depth / focal, depth - z_shift], axis=-1)
    span_y = 1 / (1 + aspect ** 2) ** 0.5
    mask = np.where(v < -0.8 * span_y, 0.05, 0.95)
    return points.astype(np.float32), mask.astype(np.float32)


def _write_hoi_crops(dirs: dict, image_id: str, is_right: bool, size: int, moge_grid,
                     fov_deg: float, seed: int) -> None:
    """One image's inputs of stages 5-8 that no ported stage makes: the HOI
    crop {id}_cropped_hoi_{0|1}.png with its background (HaMeR's input) and
    without it, on pure white (the Hunyuan stage's), the hand mask, and the
    MoGe mesh with fov.json (the Hunyuan-to-MoGe alignment's target)."""
    import json
    import os

    from PIL import Image

    from followmyhold_tpu_torch.utils.mesh_io import write_ply

    rng = np.random.default_rng(seed)
    s = size / 512.0
    name = f"{image_id}_cropped_hoi_{int(is_right)}.png"
    img = rng.integers(0, 256, (size, size, 3)).astype(np.uint8)
    hoi = np.zeros((size, size), bool)
    hoi[int(140 * s):int(420 * s), int(120 * s):int(400 * s)] = True
    Image.fromarray(img).save(os.path.join(dirs["cropped_hoi_dir"], name))
    Image.fromarray(np.where(hoi[..., None], np.minimum(img, 250), 255).astype(np.uint8)).save(
        os.path.join(dirs["cropped_hoi_wo_bckg_dir"], name))
    hand = np.zeros((size, size), np.uint8)
    hand[int(160 * s):int(320 * s), int(160 * s):int(320 * s)] = 255
    Image.fromarray(hand).save(os.path.join(dirs["mask_dir"], f"{image_id}_cropped_hand_mask.png"))
    moge_dir = os.path.join(dirs["moge_out_dir"], f"{image_id}_cropped_hoi")
    os.makedirs(moge_dir, exist_ok=True)
    write_ply(os.path.join(moge_dir, "mesh.ply"), *moge_grid_mesh(*moge_grid, size, fov_deg, seed))
    with open(os.path.join(moge_dir, "fov.json"), "w", encoding="utf-8") as f:
        json.dump({"fov_x": fov_deg}, f)


def write_stage_inputs(root: str, image_id: str = "000001", size: int = 512,
                       moge_grid=(384, 512), fov_deg: float = 60.0, seed: int = 0,
                       hoi_ids=()) -> dict:
    """Synthetic artifacts of one image, written under ``root`` with the file
    names the guidance stage reads: the RGBA crop, the hand and object masks,
    the MoGe grid mesh with fov.json, T_h2m, the synthetic hand as the aligned
    MANO mesh, the HaMeR keypoints and J_regressor_hamer.npy. -> the
    directories, keyed as ``guidance.run.run``'s arguments.

    Each of ``hoi_ids`` also gets the inputs of stages 5-8 (``_write_hoi_crops``;
    the k-th a right hand for odd k), under ``cropped_hoi_dir`` and
    ``cropped_hoi_wo_bckg_dir``; the stages' outputs belong in directories of
    their own, since these hold the guidance stage's synthetic ones."""
    import json
    import os

    from PIL import Image

    from followmyhold_tpu_torch.utils.mesh_io import write_ply

    dirs = {k: os.path.join(root, k) for k in (
        "cropped_obj_img_dir", "mask_dir", "moge_out_dir", "hunyuan_hoi_mesh_dir",
        "hamer_out_dir", "h2m_rt_dir", "aligned_mano_dir", "guidance_out_dir")}
    if hoi_ids:
        dirs.update({k: os.path.join(root, k)
                     for k in ("cropped_hoi_dir", "cropped_hoi_wo_bckg_dir")})
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    s = size / 512.0

    rgba = rng.integers(0, 256, (size, size, 4)).astype(np.uint8)
    rgba[..., 3] = 255
    Image.fromarray(rgba, "RGBA").save(
        os.path.join(dirs["cropped_obj_img_dir"], f"{image_id}_cropped_inpainted.png"))
    hand = np.zeros((size, size), np.uint8)
    hand[int(160 * s):int(320 * s), int(160 * s):int(320 * s)] = 255
    obj = np.zeros((size, size), np.uint8)
    obj[int(240 * s):int(400 * s), int(240 * s):int(400 * s)] = 255
    Image.fromarray(hand).save(os.path.join(dirs["mask_dir"], f"{image_id}_cropped_hand_mask.png"))
    Image.fromarray(obj).save(os.path.join(dirs["mask_dir"], f"{image_id}_cropped_obj_mask.png"))

    moge_dir = os.path.join(dirs["moge_out_dir"], f"{image_id}_cropped_hoi")
    os.makedirs(moge_dir, exist_ok=True)
    write_ply(os.path.join(moge_dir, "mesh.ply"), *moge_grid_mesh(*moge_grid, size, fov_deg, seed))
    with open(os.path.join(moge_dir, "fov.json"), "w", encoding="utf-8") as f:
        json.dump({"fov_x": fov_deg}, f)

    # the object's box (+-1.1) 3 m in front of the camera at unit scale, and the
    # hand in MoGe space as hand_scene places it, stored in the object's space
    t_h2m = np.eye(4, dtype=np.float32)
    t_h2m[2, 3] = -3.0
    np.save(os.path.join(dirs["h2m_rt_dir"], f"{image_id}_hoi_mesh.npy"), t_h2m)
    mano = synthetic_mano(device="cpu")
    v = mano.v_template.numpy()
    v_moge = v - v.mean(0) + np.array([0.0, 0.0, -0.8], np.float32)
    v_hun = v_moge - t_h2m[:3, 3]
    write_ply(os.path.join(dirs["aligned_mano_dir"], f"{image_id}_hamer_aligned_mano.ply"),
              v_hun.astype(np.float32), mano.faces.numpy())
    kps = rng.uniform(80 * s, 432 * s, (21, 2)).astype(np.float32)
    np.save(os.path.join(dirs["hamer_out_dir"], f"{image_id}_kps_for_guidance.npy"),
            {"mano_2d_kps": kps}, allow_pickle=True)
    np.save(os.path.join(dirs["hamer_out_dir"], "J_regressor_hamer.npy"),
            mano.j_regressor.numpy())
    for k, hoi_id in enumerate(hoi_ids):
        _write_hoi_crops(dirs, hoi_id, k % 2 == 1, size, moge_grid, fov_deg,
                         seed if hoi_id == image_id else seed + 1 + k)
    return dirs
