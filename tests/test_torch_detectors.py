"""The port's learned hand detectors against the JAX package: ``ops/nms.py``
(NMS, ROIAlign), ``models/yolov8.py`` and ``models/hand_object_detector.py``,
at the reference's tiny configurations in float32 on the same weights
(tests/_torch_detector_models.py: no JAX init runs, each JAX apply is jitted
once).

Tolerances:
- NMS keep masks: equal, ties in the scores included (both sort stably);
- ROIAlign: 1e-5 absolute (the same four taps a sample, summed in the same
  order, on values of order 1);
- anchors (numpy in both): bit for bit; ``decode_deltas``: bit for bit where
  the width and height deltas are 0, else within 2 ulps of the largest
  coordinate, because XLA's and torch's float32 exp differ by one ulp on about
  a third of the inputs (measured: 34 of 96; 59 of the 1,152 corners differ,
  by at most 9.8e-4 at ~1,000 px);
- model outputs: 1e-4 * max|ref| + 1e-5 (float32 convolutions summed in
  another order);
- final boxes in image pixels: 1e-3 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followmyhold_tpu.models import hand_object_detector as JR
from followmyhold_tpu.models import yolov8 as JY
from followmyhold_tpu.ops import nms as JN
from followmyhold_tpu_torch.models import hand_object_detector as TR
from followmyhold_tpu_torch.models import yolov8 as TY
from followmyhold_tpu_torch.ops import nms as TN
from followmyhold_tpu_torch.tools._scene import hoi_photo

from _torch_detector_models import boxes_close, close, frcnn, highest, yolo


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _photo():
    return hoi_photo(96, 128, seed=0)


# ---- NMS and ROIAlign --------------------------------------------------- #

def _boxes(seed, n):
    """Random xyxy boxes, a quarter of them duplicated, scores with ties."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(4, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    dup = rng.choice(n, n // 4, replace=False)
    boxes[dup] = boxes[rng.choice(n, n // 4)]
    scores = rng.choice(np.linspace(0.1, 0.9, 9), n).astype(np.float32)   # many ties
    return boxes, scores


@pytest.mark.parametrize("seed,n,thresh,max_out", [
    (0, 64, 0.5, None), (1, 200, 0.3, None), (2, 200, 0.7, 12), (3, 37, 0.5, 5)])
def test_nms_keep_mask_equals_the_reference(seed, n, thresh, max_out):
    boxes, scores = _boxes(seed, n)
    want = np.asarray(JN.nms(jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out=max_out))
    got = TN.nms(torch.from_numpy(boxes), torch.from_numpy(scores), thresh,
                 max_out=max_out).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < n


def test_roi_align_matches_the_reference():
    rng = np.random.default_rng(4)
    feat = rng.normal(size=(9, 13, 5)).astype(np.float32)
    # boxes inside, across every border, wholly outside, and degenerate
    boxes = np.array([[1, 1, 8, 6], [-3, -2, 5, 4], [10, 6, 16, 12], [-6, -6, -1, -1],
                      [4.2, 3.7, 4.2, 3.7], [0, 0, 13, 9]], np.float32) * 1.5
    want = highest(lambda f, b: JN.roi_align(f, b, (7, 7), spatial_scale=0.5))(feat, boxes)
    got = TN.roi_align(torch.from_numpy(feat), torch.from_numpy(boxes), (7, 7),
                       spatial_scale=0.5)
    assert got.shape == (6, 7, 7, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ---- the Faster R-CNN's anchors and host functions ---------------------- #

def test_anchors_are_bit_exact_and_decode_deltas_matches():
    for args in ((), (16, (0.5, 1.0, 2.0), (8, 16)), (8, (1.0,), (2, 4, 8))):
        base = TR.generate_anchors(*args)
        np.testing.assert_array_equal(base, JR.generate_anchors(*args))
        np.testing.assert_array_equal(TR.shift_anchors(base, 5, 7, 16),
                                      JR.shift_anchors(base, 5, 7, 16))
    rng = np.random.default_rng(5)
    anchors = TR.shift_anchors(TR.generate_anchors(), 6, 4, 16)
    deltas = rng.normal(scale=2.0, size=anchors.shape).astype(np.float32)   # clamps at +-5
    for some in (deltas * np.float32([1, 1, 0, 0]), deltas):
        want = np.asarray(JR.decode_deltas(jnp.asarray(anchors), jnp.asarray(some)))
        got = TR.decode_deltas(torch.from_numpy(anchors),
                               torch.from_numpy(some)).numpy()
        if not some[:, 2:].any():
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2 * np.spacing(np.abs(want).max()))


def test_match_hands_to_objects_matches_the_reference():
    rng = np.random.default_rng(6)
    for n_obj in (0, 1, 4):
        objs = rng.uniform(0, 100, (n_obj, 4)).astype(np.float32)
        hands = rng.uniform(0, 100, (5, 4)).astype(np.float32)
        contact = rng.integers(0, 3, 5)
        offsets = rng.normal(scale=0.05, size=(5, 3)).astype(np.float32)
        assert (TR.match_hands_to_objects(objs, hands, contact, offsets)
                == JR.match_hands_to_objects(objs, hands, contact, offsets))


# ---- YOLOv8 ------------------------------------------------------------- #

def test_yolov8_forward_matches_the_reference():
    p = yolo()
    x = np.random.default_rng(7).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    want_boxes, want_scores = p.jax_model.apply(p.params, jnp.asarray(x))
    with torch.no_grad():
        boxes, scores = p.torch_model(torch.from_numpy(x))
    assert boxes.shape == (2, 84, 4) and scores.shape == (2, 84, 2)
    close(boxes, want_boxes, "boxes")
    close(scores, want_scores, "scores")


def test_detect_hands_yolov8_matches_the_reference():
    p = yolo()
    img = _photo()
    want = JY.detect_hands_yolov8(p.jax_model, p.params, img)
    got = TY.detect_hands_yolov8(p.torch_model, img)
    assert 0 < len(got) == len(want) <= 10
    for g, w in zip(got, want):
        boxes_close(g["box"], w["box"])
        assert g["is_right"] == w["is_right"]
        assert abs(g["score"] - w["score"]) <= 1e-5


# ---- the Faster R-CNN --------------------------------------------------- #

def test_hand_object_detector_matches_the_reference():
    p = frcnn()
    blob, _ = JR.preprocess_image(_photo())
    got_blob, _ = TR.preprocess_image(_photo())
    np.testing.assert_array_equal(got_blob, blob)
    want = p.jax_model.apply(p.params, jnp.asarray(blob))
    with torch.no_grad():
        got = p.torch_model(torch.from_numpy(np.ascontiguousarray(blob)))
    assert set(got) == set(want)
    n = TR.FRCNN_TINY.post_nms_top_n
    assert got["rois"].shape == (n, 4) and (got["roi_scores"] > 0).all()
    for key in sorted(want):
        close(got[key], want[key], key)


def test_detect_hand_object_matches_the_reference():
    p = frcnn()
    want = JR.detect_hand_object(p.jax_model, p.params, _photo())
    got = TR.detect_hand_object(p.torch_model, _photo())
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            boxes_close(g, w)
    assert any(w is not None for w in want)       # a class passes the threshold
