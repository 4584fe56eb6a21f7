"""The detection and segmentation bundle of the preprocess stage (stage 2).

Counterpart of followmyhold_tpu/preprocess/detectors.py. The original
pipeline chains four learned models (a Faster R-CNN hand-object detector, a
YOLO hand detector, GroundingDINO and SAM2 for text-prompted masks); they
plug into the ``DetectorBundle`` protocol. ``HeuristicBundle`` is the
classical stand-in the reference runs without converted weights (cv2 and
numpy, unchanged): skin colour in YCrCb for the hand, a central-saliency
foreground for the object. ``default_bundle`` picks as the reference picks:
``LearnedBundle`` where its four converted files exist, else the heuristic
one. The learned models run on the device given; the heuristics on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, Tuple

import numpy as np

from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device
from followmyhold_tpu_torch.utils.params import has_params, init_random_, load_or_init

# the converted files of the learned bundle
LEARNED_PARAMS = ("yolov8_wilor", "hand_object_detector", "gdino", "sam2")


@dataclass
class Detection:
    box_xyxy: np.ndarray   # [4]
    score: float
    is_right: Optional[bool] = None


class DetectorBundle(Protocol):
    def detect_hands(self, image_rgb: np.ndarray) -> List[Detection]: ...

    def detect_hand_object(self, image_rgb: np.ndarray
                           ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """-> (object box, hand box), xyxy, either None where none is found."""
        ...

    def segment(self, image_rgb: np.ndarray, prompt: str) -> np.ndarray:
        """The text-prompted mask [H,W] bool."""
        ...


def _largest_component_box(mask: np.ndarray) -> Optional[np.ndarray]:
    """The xyxy box of the mask's largest connected component, or None."""
    import cv2

    n, labels, stats, _ = cv2.connectedComponentsWithStats(mask.astype(np.uint8))
    if n <= 1:
        return None
    areas = stats[1:, cv2.CC_STAT_AREA]
    i = 1 + int(np.argmax(areas))
    x, y, w, h = stats[i, :4]
    return np.array([x, y, x + w, y + h], np.float32)


class HeuristicBundle:
    """The classical bundle: no learned weights."""

    def skin_mask(self, image_rgb: np.ndarray) -> np.ndarray:
        import cv2

        ycrcb = cv2.cvtColor(image_rgb, cv2.COLOR_RGB2YCrCb)
        mask = cv2.inRange(ycrcb, (0, 133, 77), (255, 180, 135)) > 0
        kernel = np.ones((5, 5), np.uint8)
        mask = cv2.morphologyEx(mask.astype(np.uint8), cv2.MORPH_OPEN, kernel)
        mask = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, kernel)
        return mask > 0

    def foreground_mask(self, image_rgb: np.ndarray) -> np.ndarray:
        """Central-saliency foreground: Otsu's threshold on the blurred
        gradient magnitude, closed by 15x15."""
        import cv2

        gray = cv2.cvtColor(image_rgb, cv2.COLOR_RGB2GRAY)
        gx = cv2.Sobel(gray, cv2.CV_32F, 1, 0)
        gy = cv2.Sobel(gray, cv2.CV_32F, 0, 1)
        mag = cv2.GaussianBlur(np.hypot(gx, gy), (21, 21), 0)
        mag8 = cv2.normalize(mag, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)
        _, th = cv2.threshold(mag8, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        mask = cv2.morphologyEx(th, cv2.MORPH_CLOSE, np.ones((15, 15), np.uint8))
        return mask > 0

    def detect_hands(self, image_rgb: np.ndarray) -> List[Detection]:
        box = _largest_component_box(self.skin_mask(image_rgb))
        if box is None:
            return []
        # the heuristic cannot tell the hands apart: right, the dataset's convention
        return [Detection(box_xyxy=box, score=0.5, is_right=True)]

    def detect_hand_object(self, image_rgb: np.ndarray):
        skin = self.skin_mask(image_rgb)
        obj = self.foreground_mask(image_rgb) & ~skin
        return _largest_component_box(obj), _largest_component_box(skin)

    def segment(self, image_rgb: np.ndarray, prompt: str) -> np.ndarray:
        if "hand" in prompt.lower():
            return self.skin_mask(image_rgb)
        return self.foreground_mask(image_rgb) & ~self.skin_mask(image_rgb)


class LearnedBundle:
    """The learned stack on ``device``: YOLOv8 for the hands, the Faster
    R-CNN hand-object detector, GroundingDINO and SAM2 for the text-prompted
    masks, at the reference's configurations (``configs`` replaces any of
    "yolo", "frcnn", "gdino" and "sam2"). Each model loads its converted file
    where it exists and draws seeded random weights where it does not
    (``utils.params.load_or_init``). Nothing falls back: a model that fails to
    build or run raises."""

    def __init__(self, device: DeviceLike = "cuda", configs: Optional[dict] = None):
        from followmyhold_tpu_torch.models.gdino import GDINO_BASE, GroundingDino
        from followmyhold_tpu_torch.models.hand_object_detector import (
            FrcnnConfig,
            HandObjectDetector,
        )
        from followmyhold_tpu_torch.models.sam2 import SAM2_LARGE, Sam2
        from followmyhold_tpu_torch.models.yolov8 import YOLOV8_N, YoloV8

        dev = resolve_device(device)
        cfg = {"yolo": YOLOV8_N, "frcnn": FrcnnConfig(), "gdino": GDINO_BASE,
               "sam2": SAM2_LARGE, **(configs or {})}

        def build(name, module):
            return load_or_init(name, module, init_random_).eval()

        self.yolo = build("yolov8_wilor", YoloV8(cfg["yolo"], device=dev))
        self.frcnn = build("hand_object_detector", HandObjectDetector(cfg["frcnn"], device=dev))
        self.gdino = build("gdino", GroundingDino(cfg["gdino"], device=dev))
        self.sam = build("sam2", Sam2(cfg["sam2"], device=dev))

    def detect_hands(self, image_rgb: np.ndarray) -> List[Detection]:
        from followmyhold_tpu_torch.models.yolov8 import detect_hands_yolov8

        return [Detection(box_xyxy=d["box"], score=d["score"], is_right=d["is_right"])
                for d in detect_hands_yolov8(self.yolo, image_rgb)]

    def detect_hand_object(self, image_rgb: np.ndarray):
        from followmyhold_tpu_torch.models.hand_object_detector import detect_hand_object

        return detect_hand_object(self.frcnn, image_rgb)

    def segment(self, image_rgb: np.ndarray, prompt: str) -> np.ndarray:
        """GroundingDINO's best box for the prompt, segmented by SAM2; empty
        where no box passes the threshold."""
        from followmyhold_tpu_torch.models.gdino import detect_text_prompt
        from followmyhold_tpu_torch.models.sam2 import segment_box

        boxes, _ = detect_text_prompt(self.gdino, image_rgb, prompt)
        mask = np.zeros(image_rgb.shape[:2], bool)
        for box in boxes[:1]:
            mask |= segment_box(self.sam, image_rgb, box)
        return mask


def default_bundle(device: DeviceLike = "cuda") -> DetectorBundle:
    """``LearnedBundle`` on ``device`` where its four converted files exist,
    else the heuristic bundle (the pipeline runs without downloads)."""
    if all(has_params(n) for n in LEARNED_PARAMS):
        return LearnedBundle(device=device)
    return HeuristicBundle()
