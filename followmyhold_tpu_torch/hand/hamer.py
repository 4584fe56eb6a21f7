"""The hand stage: HaMeR regression over the cropped HOI images.

Counterpart of followmyhold_tpu/hand/hamer.py, with the same inputs
({id}_cropped_hoi_{is_right}.png, {id}_cropped_hand_mask.png) and outputs:
per image {id}.npy (the full outputs, stacked over hands),
{id}_kps_for_guidance.npy (mano_3d_kps, mano_2d_kps, cam_t), {id}_hamer.obj
(the hand in the camera frame), optionally {id}_overlay.png, and once
J_regressor_hamer.npy, which the guidance stage reads.

Per hand: the box (ViTDetDataset's math: square, rescaled 2.5x), the
256x256 patch (mirrored for a left hand), ImageNet normalisation, the
network and the MANO forward, the left hand's x un-mirrored,
``cam_crop_to_full`` and the keypoints projected into the full image.

The box comes from the hand mask, or is the whole frame when there is none:
the reference's behaviour without ViTPose or GroundingDINO weights, whose
models are not ported (ROADMAP queue 1, item 7), so ``multi_hand=True``
raises.

    python -m followmyhold_tpu_torch.hand.hamer --img_folder ... --out_folder ... \\
        [--mask_dir ...] [--save_overlay] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import traceback
from typing import Optional

import numpy as np
import torch
from PIL import Image

from followmyhold_tpu_torch.configs.profiles import is_tiny
from followmyhold_tpu_torch.models.hamer import Hamer, HamerConfig, hamer_forward
from followmyhold_tpu_torch.models.mano import ManoModel, load_mano
from followmyhold_tpu_torch.models.vit import ViTConfig
from followmyhold_tpu_torch.ops.camera import (
    GuidanceCamera,
    cam_crop_to_full,
    perspective_projection,
)
from followmyhold_tpu_torch.ops.image import generate_patch_image
from followmyhold_tpu_torch.ops.rasterizer import TILE_H, TILE_W, render_normal_and_disparity
from followmyhold_tpu_torch.ops.surface import PaddedMesh, vertex_normals
from followmyhold_tpu_torch.utils.artifacts import parse_cropped_hoi_name, should_skip
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device
from followmyhold_tpu_torch.utils.mesh_io import write_obj
from followmyhold_tpu_torch.utils.params import init_random_, load_or_init

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# the random-weight readout's scale (xavier gain 0.01, HaMeR's INIT_DECODER_XAVIER):
# it keeps the hand near the mean pose and camera, in front of the camera
_READOUT_GAIN = 0.01

# the per-hand arrays of {id}.npy, stacked over hands
_STACK_KEYS = ("pred_cam", "pred_cam_t", "pred_cam_t_full", "pred_vertices",
               "pred_keypoints_3d", "pred_keypoints_2d", "betas", "global_orient",
               "hand_pose", "box_center", "box_size", "right")


def nms_boxes(boxes: np.ndarray, scores: np.ndarray, thresh: float = 0.5) -> np.ndarray:
    """Greedy IoU NMS of xyxy boxes -> the kept indices, best first."""
    def area(bb):
        return np.maximum(bb[..., 2] - bb[..., 0], 0) * np.maximum(bb[..., 3] - bb[..., 1], 0)

    order = np.argsort(-scores)
    keep = []
    while len(order):
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        if not len(rest):
            break
        b = boxes[i]
        xx0 = np.maximum(b[0], boxes[rest, 0])
        yy0 = np.maximum(b[1], boxes[rest, 1])
        xx1 = np.minimum(b[2], boxes[rest, 2])
        yy1 = np.minimum(b[3], boxes[rest, 3])
        inter = np.maximum(xx1 - xx0, 0) * np.maximum(yy1 - yy0, 0)
        iou = inter / np.maximum(area(b[None]) + area(boxes[rest]) - inter, 1e-9)
        order = rest[iou <= thresh]
    return np.asarray(keep, np.int64)


def _hand_bbox_from_mask(mask_path: Optional[str], img_hw) -> np.ndarray:
    """xyxy box of the hand mask's pixels; the whole image without a mask."""
    H, W = img_hw
    if mask_path and os.path.exists(mask_path):
        ys, xs = np.nonzero(np.asarray(Image.open(mask_path).convert("L")) > 0)
        if len(xs) > 0:
            return np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)
    return np.array([0, 0, W - 1, H - 1], np.float32)


def _default_config() -> HamerConfig:
    """ViT-H and the full head, or the reference's tiny profile
    (FOHO_TPU_PROFILE=tiny)."""
    if is_tiny():
        return HamerConfig(
            backbone=ViTConfig(img_size=(64, 48), patch_size=16, embed_dim=32, depth=1,
                               num_heads=2, dtype=torch.float32),
            head_dim=32, head_depth=1, head_heads=2, head_dim_head=8, head_mlp_dim=32,
            context_dim=32, image_size=64, dtype=torch.float32)
    return HamerConfig()


def _build_model(cfg: HamerConfig, seed: int = 0, device: DeviceLike = "cuda") -> Hamer:
    """HaMeR on ``device`` in eval mode, without gradients to the weights:
    the converted checkpoint ``hamer`` where its file exists, else seeded
    random weights with the mean-pose and mean-camera inits and the readout
    scaled down by ``_READOUT_GAIN``."""
    def init(model: Hamer) -> None:
        init_random_(model, seed)
        head = model.mano_head
        head.reset_mean_params_()
        with torch.no_grad():
            for layer in (head.decpose, head.decshape, head.deccam):
                layer.weight.mul_(_READOUT_GAIN)

    model = load_or_init("hamer", Hamer(cfg, device=resolve_device(device)), init)
    return model.eval().requires_grad_(False)


@torch.no_grad()
def _process_hand(model: Hamer, mano: ManoModel, cfg: HamerConfig, img: np.ndarray,
                  box: np.ndarray, is_right: bool, rescale_factor: float,
                  device: DeviceLike = "cuda") -> dict:
    """One hand -> its arrays: the box math, the crop, the forward, the left
    hand un-mirrored, ``cam_crop_to_full`` and the full-image 2-D keypoints."""
    dev = resolve_device(device)
    H, W = img.shape[:2]
    center = (box[:2] + box[2:]) / 2.0
    scale = rescale_factor * (box[2:] - box[:2]) / 200.0
    box_size = float(np.max(scale) * 200.0)
    bbox_xywh = [center[0] - box_size / 2, center[1] - box_size / 2, box_size, box_size]

    patch, _ = generate_patch_image(torch.from_numpy(img).to(dev), bbox_xywh,
                                    (cfg.image_size, cfg.image_size), do_flip=not is_right)
    patch = (patch - torch.from_numpy(IMAGENET_MEAN).to(dev)) / torch.from_numpy(
        IMAGENET_STD).to(dev)
    out = hamer_forward(model, mano, patch[None])

    mult = 1.0 if is_right else -1.0
    pred_cam = out.pred_cam.float().clone()
    pred_cam[:, 1] *= mult                       # un-mirror tx
    img_size = torch.tensor([[W, H]], dtype=torch.float32, device=dev)
    scaled_focal = cfg.focal_length / cfg.image_size * float(max(W, H))
    cam_t_full = cam_crop_to_full(pred_cam, torch.from_numpy(center[None]).to(dev),
                                  torch.tensor([box_size], dtype=torch.float32, device=dev),
                                  img_size, scaled_focal)
    flip = torch.tensor([mult, 1.0, 1.0], device=dev)
    verts = out.vertices[0] * flip
    kps3d = out.keypoints_3d[0] * flip
    kps2d_full = perspective_projection(
        kps3d[None], cam_t_full, torch.tensor([[scaled_focal, scaled_focal]], device=dev),
        torch.tensor([[W / 2.0, H / 2.0]], device=dev))[0]

    def host(t):
        return t.float().cpu().numpy()

    return {
        "pred_cam": host(pred_cam[0]),
        "pred_cam_t": host(out.pred_cam_t[0]),
        "pred_cam_t_full": host(cam_t_full[0]),
        "pred_vertices": host(verts),
        "pred_keypoints_3d": host(kps3d),
        "pred_keypoints_2d": host(out.keypoints_2d[0]),
        "betas": host(out.betas[0]),
        "global_orient": host(out.global_orient[0]),
        "hand_pose": host(out.hand_pose[0]),
        "box_center": center,
        "box_size": np.asarray(box_size),
        "right": np.asarray(float(is_right)),
        "scaled_focal": scaled_focal,
        "mano_2d_kps": host(kps2d_full),
    }


def overlay_scene(hands: list, faces: np.ndarray, frame_hw, scaled_focal: float,
                  device: DeviceLike = "cuda"):
    """What the overlay renders: the frame padded to the rasterizer's tiles,
    the camera of focal ``scaled_focal`` on it, and every hand's mesh in the
    camera frame (GL convention). -> (camera, verts [V,3], faces [F,3] int64,
    (top, left) padding)."""
    dev = resolve_device(device)
    H, W = frame_hw
    Hp, Wp = -(-H // TILE_H) * TILE_H, -(-W // TILE_W) * TILE_W
    fov = 2.0 * math.degrees(math.atan((min(Hp, Wp) - 1) / 2.0 / scaled_focal))
    all_v, all_f, off = [], [], 0
    for h in hands:
        v = h["pred_vertices"] + h["pred_cam_t_full"]
        all_v.append(v * np.array([1.0, -1.0, -1.0], np.float32))   # OpenCV -> GL
        all_f.append(np.asarray(faces, np.int64) + off)
        off += len(v)
    verts = torch.from_numpy(np.concatenate(all_v).astype(np.float32)).to(dev)
    return (GuidanceCamera(height=Hp, width=Wp, fov_deg=fov), verts,
            torch.from_numpy(np.concatenate(all_f)).to(dev), ((Hp - H) // 2, (Wp - W) // 2))


@torch.no_grad()
def render_overlay(img01: np.ndarray, hands: list, faces: np.ndarray, scaled_focal: float,
                   device: DeviceLike = "cuda") -> np.ndarray:
    """The normal-shaded MANO meshes over the frame -> uint8 [H,W,3]. The
    frame is padded to the rasterizer's tiles and cropped back; each tile
    may hold every face, so none is dropped."""
    dev = resolve_device(device)
    H, W = img01.shape[:2]
    cam, verts, fcs, (py, px) = overlay_scene(hands, faces, (H, W), scaled_focal, dev)
    canvas = torch.zeros((cam.height, cam.width, 3), dtype=torch.float32, device=dev)
    canvas[py:py + H, px:px + W] = torch.from_numpy(np.asarray(img01, np.float32)).to(dev)
    mesh = PaddedMesh(verts=verts, faces=fcs, vert_mask=torch.ones(verts.shape[0], device=dev),
                      face_mask=torch.ones(fcs.shape[0], device=dev))
    n01, _, out = render_normal_and_disparity(cam, verts, fcs, vertex_normals(mesh),
                                              mesh.face_mask,
                                              faces_per_tile=overlay_faces_per_tile(fcs.shape[0]),
                                              device=dev)
    hit = (out.face_id >= 0)[..., None]
    over = torch.where(hit, 0.7 * n01 + 0.3 * canvas, canvas)
    over = over[py:py + H, px:px + W].clamp(0, 1).cpu().numpy()
    return (over * 255).astype(np.uint8)


def overlay_faces_per_tile(n_faces: int) -> int:
    """A tile's capacity at or above the total face count: none can overflow."""
    return -(-n_faces // 128) * 128


def run(
    img_folder: str,
    out_folder: str,
    full_img_dir: Optional[str] = None,   # accepted for CLI parity, unused
    mask_dir: Optional[str] = None,
    save_mesh: bool = True,
    rescale_factor: float = 2.5,
    hamer_demo_dir: Optional[str] = None,  # accepted for CLI parity, unused
    multi_hand: bool = False,
    save_overlay: bool = False,
    model: Optional[Hamer] = None,
    device: DeviceLike = "cuda",
) -> None:
    """Every crop of ``img_folder`` through HaMeR. ``model`` is a built
    ``Hamer`` on ``device`` (default: ``_build_model(_default_config())``).
    An image whose two .npy files exist is skipped."""
    if multi_hand:
        raise NotImplementedError(
            "multi_hand needs the ViTPose and GroundingDINO front ends, which are not ported "
            "yet (ROADMAP queue 1, item 7)")
    dev = resolve_device(device)
    os.makedirs(out_folder, exist_ok=True)
    cfg = model.cfg if model is not None else _default_config()
    if model is None:
        model = _build_model(cfg, device=dev)
    mano = load_mano(device=dev)
    np.save(os.path.join(out_folder, "J_regressor_hamer.npy"), mano.j_regressor.cpu().numpy())

    images = sorted(glob.glob(os.path.join(img_folder, "*.png"))
                    + glob.glob(os.path.join(img_folder, "*.jpg")))
    if not images:
        print(f"No images found in {img_folder}")
        return
    faces = mano.faces.cpu().numpy()

    for img_path in images:
        image_id, is_right = parse_cropped_hoi_name(img_path)
        out_npy = os.path.join(out_folder, f"{image_id}.npy")
        kps_npy = os.path.join(out_folder, f"{image_id}_kps_for_guidance.npy")
        if should_skip(out_npy, kps_npy):
            print(f"{image_id} exists, skipping")
            continue

        img = np.asarray(Image.open(img_path).convert("RGB"), np.float32) / 255.0
        mask_path = (os.path.join(mask_dir, f"{image_id}_cropped_hand_mask.png")
                     if mask_dir else None)
        box = _hand_bbox_from_mask(mask_path, img.shape[:2])
        hands = [_process_hand(model, mano, cfg, img, box, is_right, rescale_factor,
                               device=dev)]

        np.save(out_npy, {k: np.stack([h[k] for h in hands]) for k in _STACK_KEYS})
        np.save(kps_npy, {
            "mano_3d_kps": np.stack([h["pred_keypoints_3d"] for h in hands]),
            "mano_2d_kps": (hands[0]["mano_2d_kps"] if len(hands) == 1 else
                            np.stack([h["mano_2d_kps"] for h in hands])),
            "cam_t": np.stack([h["pred_cam_t_full"] for h in hands]),
        })
        if save_mesh:
            for k, h in enumerate(hands):
                name = (f"{image_id}_hamer.obj" if len(hands) == 1
                        else f"{image_id}_hamer_{k}.obj")
                write_obj(os.path.join(out_folder, name),
                          h["pred_vertices"] + h["pred_cam_t_full"], faces)
        if save_overlay:
            try:
                over = render_overlay(img, hands, faces, hands[0]["scaled_focal"], device=dev)
                Image.fromarray(over).save(os.path.join(out_folder, f"{image_id}_overlay.png"))
            except Exception as e:  # the overlay is diagnostic only
                print(f"overlay render failed for {image_id}: {e}")
                traceback.print_exception(type(e), e, e.__traceback__)
        print(f"Processed {image_id} ({len(hands)} hand(s))")


def main() -> None:
    parser = argparse.ArgumentParser(description="HaMeR hand regression")
    parser.add_argument("--img_folder", required=True)
    parser.add_argument("--out_folder", required=True)
    parser.add_argument("--full_img_dir", default=None)
    parser.add_argument("--mask_dir", default=None)
    parser.add_argument("--hamer_demo_dir", default=None)
    parser.add_argument("--save_mesh", action="store_true", default=True)
    parser.add_argument("--multi_hand", action="store_true", default=False,
                        help="raw multi-person frames (not ported: raises)")
    parser.add_argument("--save_overlay", action="store_true", default=False)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    run(args.img_folder, args.out_folder, args.full_img_dir, args.mask_dir, args.save_mesh,
        hamer_demo_dir=args.hamer_demo_dir, multi_hand=args.multi_hand,
        save_overlay=args.save_overlay, device=args.device)


if __name__ == "__main__":
    main()
