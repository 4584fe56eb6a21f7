"""HOI detection, cropping and segmentation (stage 2's per-image work).

Counterpart of followmyhold_tpu/preprocess/segment_hoi.py, with the
reference's crop math: the hand-object detector's hand box matched to the
hand detector's boxes by IoU, the union of the object and hand boxes padded
by 10 px and made square times 1.25, the affine patch crop to
``crop_size()`` (on ``device``, through ``ops.image.generate_patch_image``;
mirrored for a left hand), then the object and hand masks in the crop and
the two composed images. Detection and segmentation come from a
``DetectorBundle`` (preprocess/detectors.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from followmyhold_tpu_torch.configs.profiles import crop_size
from followmyhold_tpu_torch.ops.image import box_iou, generate_patch_image, process_bbox
from followmyhold_tpu_torch.preprocess.detectors import DetectorBundle
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device

PAD_PX = 10
BBOX_FACTOR = 1.25


def hoi_detector(
    image_rgb: np.ndarray,
    bundle: DetectorBundle,
    iou_threshold: float = 0.3,
    object_name: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> dict:
    """[H,W,3] uint8 photo -> the crop (uint8), the crop without background,
    the occluded object, the object and hand masks (bool), is_right, the
    crop's 3x3 transform and its [x, y, w, h] box."""
    dev = resolve_device(device)
    H, W = image_rgb.shape[:2]

    obj_box, hod_hand_box = bundle.detect_hand_object(image_rgb)
    hands = bundle.detect_hands(image_rgb)

    # the hand: the detector's box that best overlaps the hand-object
    # detector's, else its most confident one, else the hand-object detector's
    hand_box, is_right = None, True
    if hands:
        if hod_hand_box is not None:
            ious = [float(box_iou(torch.as_tensor(h.box_xyxy), torch.as_tensor(hod_hand_box)))
                    for h in hands]
            best = int(np.argmax(ious))
            if ious[best] >= iou_threshold:
                hand_box = hands[best].box_xyxy
                is_right = bool(hands[best].is_right)
        if hand_box is None:
            best = int(np.argmax([h.score for h in hands]))
            hand_box = hands[best].box_xyxy
            is_right = bool(hands[best].is_right)
    elif hod_hand_box is not None:
        hand_box = hod_hand_box

    # the union of the object and hand boxes, padded, inside the image
    boxes = [b for b in (obj_box, hand_box) if b is not None]
    if not boxes:
        union = np.array([0, 0, W - 1, H - 1], np.float32)
    else:
        arr = np.stack(boxes)
        union = np.array([arr[:, 0].min(), arr[:, 1].min(),
                          arr[:, 2].max(), arr[:, 3].max()], np.float32)
    union[0] = max(union[0] - PAD_PX, 0)
    union[1] = max(union[1] - PAD_PX, 0)
    union[2] = min(union[2] + PAD_PX, W - 1)
    union[3] = min(union[3] + PAD_PX, H - 1)

    bbox_xywh = process_bbox([union[0], union[1], union[2] - union[0], union[3] - union[1]],
                             factor=BBOX_FACTOR)

    size = crop_size()
    image = torch.from_numpy(image_rgb.astype(np.float32)).to(dev)
    patch, T = generate_patch_image(image, bbox_xywh, (size, size), do_flip=not is_right)
    crop = np.clip(patch.cpu().numpy(), 0, 255).astype(np.uint8)

    obj_mask = bundle.segment(crop, object_name or "object")
    hand_mask = bundle.segment(crop, "only hand")

    white = np.full_like(crop, 255)
    crop_wo_bg = np.where((obj_mask | hand_mask)[..., None], crop, white)
    occluded_obj = np.where(obj_mask[..., None] & ~hand_mask[..., None], crop, white)

    return {
        "cropped_hoi": crop,
        "cropped_hoi_wo_bckg": crop_wo_bg,
        "occluded_obj": occluded_obj,
        "obj_mask": obj_mask,
        "hand_mask": hand_mask,
        "is_right": is_right,
        "transform": T,
        "bbox_xywh": bbox_xywh,
    }
