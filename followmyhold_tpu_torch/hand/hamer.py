"""The hand stage: HaMeR regression over the cropped HOI images.

Counterpart of followmyhold_tpu/hand/hamer.py, with the same inputs
({id}_cropped_hoi_{is_right}.png, {id}_cropped_hand_mask.png) and outputs:
per image {id}.npy (the full outputs, stacked over hands),
{id}_kps_for_guidance.npy (mano_3d_kps, mano_2d_kps, cam_t), {id}_hamer.obj
(the hand in the camera frame; {id}_hamer_{k}.obj for each of several hands),
optionally {id}_overlay.png, and once J_regressor_hamer.npy, which the
guidance stage reads.

The hand boxes, as the reference chooses them:

- pipeline mode (one hand a crop, its side from the file name): where a
  converted ``vitpose`` file exists, the box of the crop side's wholebody
  keypoint block (``VitPoseFrontEnd``); where that block is not confident, or
  there is no such file, the hand mask's box; without a mask, the whole frame;
- ``multi_hand=True`` (raw, possibly multi-person frames): person boxes from
  GroundingDINO prompted with "person." (``GdinoPersonDetector``, where a
  ``gdino`` file exists; else the whole frame), ViTPose on each person, and
  every survivor of a per-side NMS (``collect_hand_candidates``). Without a
  ViTPose file the reference quietly takes the mask box; the port does the
  same and says so once a run.

Per hand: the box (ViTDetDataset's math: square, rescaled 2.5x), the
256x256 patch (mirrored for a left hand), ImageNet normalisation, the
network and the MANO forward, the left hand's x un-mirrored,
``cam_crop_to_full`` and the keypoints projected into the full image.

    python -m followmyhold_tpu_torch.hand.hamer --img_folder ... --out_folder ... \\
        [--mask_dir ...] [--multi_hand] [--save_overlay] [--device cuda]
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
from followmyhold_tpu_torch.models.gdino import GDINO_BASE, GroundingDino, detect_text_prompt
from followmyhold_tpu_torch.models.hamer import Hamer, HamerConfig, hamer_forward
from followmyhold_tpu_torch.models.mano import ManoModel, load_mano
from followmyhold_tpu_torch.models.vit import ViTConfig
from followmyhold_tpu_torch.models.vitpose import (
    build_vitpose,
    hand_candidates_from_wholebody,
    heatmaps_to_keypoints,
)
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
from followmyhold_tpu_torch.utils.params import has_params, init_random_, load_or_init

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


def person_crops(img01: np.ndarray, person_boxes=None) -> list:
    """The crops of a frame that ViTPose runs on -> [((x0, y0), crop), ...]:
    each person box's pixels, clamped to the frame (boxes under 16 px
    skipped); the whole frame without boxes."""
    H, W = img01.shape[:2]
    if person_boxes is None or not len(person_boxes):
        person_boxes = [np.array([0, 0, W - 1, H - 1], np.float32)]
    crops = []
    for pb in person_boxes:
        x0, y0 = max(int(pb[0]), 0), max(int(pb[1]), 0)
        x1, y1 = min(int(pb[2]) + 1, W), min(int(pb[3]) + 1, H)
        if x1 - x0 >= 16 and y1 - y0 >= 16:
            crops.append(((x0, y0), img01[y0:y1, x0:x1]))
    return crops


def collect_hand_candidates(img01: np.ndarray, pose_front: "VitPoseFrontEnd",
                            person_boxes=None, conf_thresh: float = 0.5,
                            nms_thresh: float = 0.5):
    """A multi-person frame -> its hands [(box_xyxy, score, is_right), ...]:
    ViTPose on each of ``person_crops``, the keypoint blocks' boxes mapped
    back to the frame, then a greedy NMS of each side, lefts first."""
    cands = []
    for (x0, y0), crop in person_crops(img01, person_boxes):
        for box, score, is_right in pose_front.hand_candidates(crop, conf_thresh):
            cands.append((box + np.array([x0, y0, x0, y0], np.float32), score, is_right))
    out = []
    for side in (False, True):
        side_c = [(b, s) for b, s, r in cands if r == side]
        if not side_c:
            continue
        boxes = np.stack([b for b, _ in side_c])
        scores = np.asarray([s for _, s in side_c])
        for i in nms_boxes(boxes, scores, nms_thresh):
            out.append((boxes[i], float(scores[i]), side))
    return out


class GdinoPersonDetector:
    """Person boxes of a raw frame: GroundingDINO (``models/gdino.py``)
    prompted with "person.", every box over 0.5. The reference puts it where
    the original pipeline ran a ViTDet person detector, and builds it where a
    converted ``gdino`` file exists. ``model`` is a built ``GroundingDino``
    (default: ``GDINO_BASE`` with the file's weights, on ``device``)."""

    def __init__(self, model=None, device: DeviceLike = "cuda"):
        if model is None:
            model = GroundingDino(GDINO_BASE, device=resolve_device(device))
            model = load_or_init("gdino", model, init_random_).eval()
        self.model = model

    @classmethod
    def maybe_build(cls, device: DeviceLike = "cuda") -> Optional["GdinoPersonDetector"]:
        return cls(device=device) if has_params("gdino") else None

    def person_boxes(self, img01: np.ndarray, score_thresh: float = 0.5) -> np.ndarray:
        """[H,W,3] in [0,1] -> person boxes [N,4] xyxy in frame pixels, best first."""
        boxes, _ = detect_text_prompt(self.model, (img01 * 255).astype(np.uint8), "person.",
                                      box_threshold=score_thresh)
        return boxes


class VitPoseFrontEnd:
    """ViTPose's wholebody keypoints -> handed hand boxes, as the reference's
    front end. ``model`` is a built ``ViTPose`` (default:
    ``models.vitpose.build_vitpose``, the ``vitpose`` file's weights, on
    ``device``); the reference builds it where that file exists."""

    def __init__(self, model=None, device: DeviceLike = "cuda"):
        self.model = model if model is not None else build_vitpose(device=device)

    @classmethod
    def maybe_build(cls, device: DeviceLike = "cuda") -> Optional["VitPoseFrontEnd"]:
        return cls(device=device) if has_params("vitpose") else None

    @torch.no_grad()
    def keypoints(self, img01: np.ndarray) -> np.ndarray:
        """[H,W,3] in [0,1] -> the 133 wholebody keypoints [133,3] (x, y,
        confidence) in image pixels: a PIL resize to the backbone's input on
        the host, ImageNet normalisation, the forward on the model's device."""
        H, W = img01.shape[:2]
        ih, iw = self.model.cfg.backbone.img_size
        patch = np.asarray(Image.fromarray((img01 * 255).astype(np.uint8)).resize((iw, ih)),
                           np.float32) / 255.0
        patch = (patch - IMAGENET_MEAN) / IMAGENET_STD
        dev = self.model.final.weight.device
        heatmaps = self.model(torch.from_numpy(patch[None]).to(dev))
        kps = heatmaps_to_keypoints(heatmaps, (ih, iw))[0].cpu().numpy()
        kps[:, 0] *= W / iw
        kps[:, 1] *= H / ih
        return kps

    def hand_candidates(self, img01: np.ndarray, conf_thresh: float = 0.5):
        """-> [(box_xyxy, score, is_right), ...] from the keypoint blocks."""
        return hand_candidates_from_wholebody(self.keypoints(img01), conf_thresh)

    def hand_bbox(self, img01: np.ndarray, is_right: bool,
                  conf_thresh: float = 0.5) -> Optional[np.ndarray]:
        """The xyxy box of the side's keypoint block, or None where it has 3
        or fewer confident keypoints. The extent is kept as it is: the box
        math downstream rescales it 2.5x."""
        for box, _, side in self.hand_candidates(img01, conf_thresh):
            if side == is_right:
                return box
        return None


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
    pose_front: Optional[VitPoseFrontEnd] = None,
    person_detector: Optional[GdinoPersonDetector] = None,
    device: DeviceLike = "cuda",
) -> None:
    """Every crop of ``img_folder`` through HaMeR. ``model`` is a built
    ``Hamer`` on ``device`` (default: ``_build_model(_default_config())``);
    ``pose_front`` a ``VitPoseFrontEnd`` and ``person_detector`` (multi-hand
    mode only) a ``GdinoPersonDetector``, each built where its converted file
    exists when not given, as the reference does. An image whose two .npy
    files exist is skipped."""
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
    if pose_front is None:
        pose_front = VitPoseFrontEnd.maybe_build(dev)
    if multi_hand and person_detector is None:
        person_detector = GdinoPersonDetector.maybe_build(dev)
    if multi_hand and pose_front is None:
        print("multi_hand: no ViTPose file ('vitpose' under the assets' params), so each "
              "frame takes its hand mask's box (or the whole frame), as the reference does "
              "without one")

    for img_path in images:
        image_id, is_right = parse_cropped_hoi_name(img_path)
        out_npy = os.path.join(out_folder, f"{image_id}.npy")
        kps_npy = os.path.join(out_folder, f"{image_id}_kps_for_guidance.npy")
        if should_skip(out_npy, kps_npy):
            print(f"{image_id} exists, skipping")
            continue

        img = np.asarray(Image.open(img_path).convert("RGB"), np.float32) / 255.0
        # multi-hand mode keeps every per-side NMS survivor; pipeline mode one
        # box for the crop's side
        instances = []
        if multi_hand and pose_front is not None:
            person_boxes = (person_detector.person_boxes(img)
                            if person_detector is not None else None)
            instances = [(b, r) for b, _, r in
                         collect_hand_candidates(img, pose_front, person_boxes=person_boxes)]
        if not instances:
            box = pose_front.hand_bbox(img, is_right) if pose_front is not None else None
            if box is None:
                mask_path = (os.path.join(mask_dir, f"{image_id}_cropped_hand_mask.png")
                             if mask_dir else None)
                box = _hand_bbox_from_mask(mask_path, img.shape[:2])
            instances = [(box, is_right)]
        hands = [_process_hand(model, mano, cfg, img, box, right, rescale_factor, device=dev)
                 for box, right in instances]

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
                        help="raw multi-person frames: keep every per-side NMS survivor "
                             "instead of one hand a crop")
    parser.add_argument("--save_overlay", action="store_true", default=False)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    run(args.img_folder, args.out_folder, args.full_img_dir, args.mask_dir, args.save_mesh,
        hamer_demo_dir=args.hamer_demo_dir, multi_hand=args.multi_hand,
        save_overlay=args.save_overlay, device=args.device)


if __name__ == "__main__":
    main()
