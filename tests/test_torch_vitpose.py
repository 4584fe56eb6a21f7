"""ViTPose and the hand stage's front ends in the PyTorch port against the JAX
package: the tiny ViTPose on bridged weights and from a converted file, the
keypoint blocks and the greedy NMS with tied scores, the GroundingDINO person
detector, ``hand/hamer.run`` in multi-hand mode, and the pipeline-mode box
where a ViTPose file exists (the reference then takes the hand box from the
keypoints of the crop's side, which the port used to ignore).

The JAX trees come from ``jax.eval_shape`` filled with numpy
(``_torch_detector_models.random_params``), each JAX ``apply`` is jitted once
a process, and the module runs torch on one thread. HaMeR is
``tests/test_torch_hamer.py``'s 256-px parity configuration, on its bridged
weights.

Tolerances, float32 on both sides (measured on the CPU with these seeds):
- ViTPose's heatmaps: 1e-5 of their largest |entry| (measured 6.8e-7 of it);
- the keypoints: the positions equal at every keypoint whose reference
  heatmap has a best entry ahead of its second by more than 1e-4 of the
  largest |entry| (an argmax between nearer entries may flip with the last
  bit), the confidences as the heatmaps; on the same heatmaps, ties included,
  every keypoint equal;
- the person boxes: ``_torch_detector_models.boxes_close`` (1e-3 px);
- ``run``'s arrays: as ``test_torch_hamer.py``'s end-to-end test, 2e-4 of each
  array's largest entry plus 1e-4; the boxes equal to 1e-4 px.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from followmyhold_tpu.hand import hamer as JHH
from followmyhold_tpu.models import hamer as JMH
from followmyhold_tpu.models import mano as JM
from followmyhold_tpu.models import vitpose as JVP
from followmyhold_tpu.utils import params as JP
from followmyhold_tpu_torch.hand import hamer as THH
from followmyhold_tpu_torch.models import vitpose as TVP
from followmyhold_tpu_torch.tools._scene import two_person_frame, write_gdino_vocab
from followmyhold_tpu_torch.utils.params import flax_to_torch

from _torch_detector_models import boxes_close, gdino, highest, random_params
from test_torch_hamer import _bridged_hamer, _write_crop

# the final bias of the hand keypoints' heatmaps in the tiny ViTPose: random
# heatmaps put few keypoints over 0.5, this lifts every hand keypoint over it
_HAND_BIAS = 1.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_params(seed=21, hand_bias=0.0):
    """The tiny ViTPose's Flax tree: random_params' draws with the folded
    BatchNorm scales around 1 and ``hand_bias`` added to the hand keypoints'
    final bias."""
    m = JVP.ViTPose(JVP.VITPOSE_TINY)
    ih, iw = m.cfg.backbone.img_size
    params = random_params(lambda k: m.init(k, jnp.zeros((1, ih, iw, 3))), seed)
    inner = params["params"]
    for i in range(m.cfg.num_deconv):
        inner[f"bn{i}_scale"] += 1.0
    inner["final"]["bias"][91:133] += hand_bias
    return m, params


@functools.lru_cache(maxsize=None)
def _pair(seed=21):
    m, params = _tiny_params(seed)
    return m, params, highest(m.apply), flax_to_torch(params, TVP.ViTPose(TVP.VITPOSE_TINY)).eval()


def _images(n=2, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 64, 48, 3)).astype(np.float32)


def _decided(heatmaps: np.ndarray) -> np.ndarray:
    """[B,K] whether each heatmap's best entry leads its second by more than
    1e-4 of the largest |entry|."""
    B, h, w, K = heatmaps.shape
    top2 = np.sort(heatmaps.reshape(B, h * w, K), axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > 1e-4 * np.abs(heatmaps).max()


def test_vitpose_heatmaps_and_keypoints_match_the_reference():
    _, params, apply, tmodel = _pair()
    x = _images()
    want = np.asarray(apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 16, 12, 133) and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())

    want_kps = np.asarray(JVP.heatmaps_to_keypoints(jnp.asarray(want), (64, 48)))
    got_kps = TVP.heatmaps_to_keypoints(got, (64, 48)).numpy()
    decided = _decided(want)
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(got_kps[decided][:, :2], want_kps[decided][:, :2])
    np.testing.assert_allclose(got_kps[..., 2], want_kps[..., 2], rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # on the same heatmaps the keypoints are equal everywhere
    np.testing.assert_array_equal(
        TVP.heatmaps_to_keypoints(torch.from_numpy(want), (64, 48)).numpy(), want_kps)


def test_heatmap_ties_take_the_first_maximum():
    hm = np.zeros((1, 4, 3, 5), np.float32)
    hm[0, 1, 2, 0] = hm[0, 3, 0, 0] = 2.0          # a tie across rows
    hm[0, 2, 1, 1] = hm[0, 2, 2, 1] = 1.0          # a tie within a row
    hm[0, :, :, 2] = 0.5                            # every entry tied
    hm[0, :, :, 3] = -2.0                           # a tie of the first and the last entry
    hm[0, 0, 0, 3] = hm[0, 3, 2, 3] = 1.0
    want = np.asarray(JVP.heatmaps_to_keypoints(jnp.asarray(hm), (16, 12)))
    got = TVP.heatmaps_to_keypoints(torch.from_numpy(hm), (16, 12)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :4, :2], [[8, 4], [4, 8], [0, 0], [0, 0]])


def test_vitpose_from_a_converted_file(tmp_path, monkeypatch):
    """``build_vitpose`` loads <assets>/params/vitpose.msgpack, written by the
    JAX package's save_params, through load_or_init; without the file it
    draws seeded random weights with the identity BatchNorms."""
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path))
    fresh = TVP.build_vitpose(TVP.VITPOSE_TINY, device="cpu")
    assert not fresh.training and not any(p.requires_grad for p in fresh.parameters())
    assert float(fresh.bn0_scale.min()) == float(fresh.bn0_scale.max()) == 1.0
    _, params, apply, _ = _pair()
    JP.save_params("vitpose", params)
    model = TVP.build_vitpose(TVP.VITPOSE_TINY, device="cpu")
    x = _images(1, seed=3)
    want = np.asarray(apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError, match="vitpose.msgpack"):
        TVP.build_vitpose(dataclasses.replace(TVP.VITPOSE_TINY, deconv_channels=8),
                          device="cpu")


def _keypoints(seed):
    """Wholebody keypoints with confident, unconfident and tied hand blocks."""
    rng = np.random.default_rng(seed)
    kps = np.concatenate([rng.uniform(0, 60, (133, 2)), rng.uniform(0, 1, (133, 1))], 1)
    kps = kps.astype(np.float32)
    kps[112:133, 2] = np.where(np.arange(21) < 3, 0.9, 0.2)      # 3 confident: not valid
    if seed % 2:
        kps[112:133, 2] = 0.5                                     # at the threshold: not over
        kps[112:116, 2] = 0.75
    return kps


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_keypoint_blocks_match_the_reference(seed):
    kps = _keypoints(seed)
    for thresh in (0.5, 0.3):
        want = JVP.hand_candidates_from_wholebody(kps, thresh)
        got = TVP.hand_candidates_from_wholebody(kps, thresh)
        assert [(s, r) for _, s, r in got] == [(s, r) for _, s, r in want]
        for (gb, _, _), (wb, _, _) in zip(got, want):
            np.testing.assert_array_equal(gb, wb)
        for gb, wb in zip(TVP.hand_bboxes_from_wholebody(kps, thresh),
                          JVP.hand_bboxes_from_wholebody(kps, thresh)):
            assert (gb is None) == (wb is None)
            if wb is not None:
                np.testing.assert_array_equal(gb, wb)


def test_nms_boxes_matches_the_reference_with_ties():
    rng = np.random.default_rng(5)
    boxes = rng.uniform(0, 50, (40, 2))
    boxes = np.concatenate([boxes, boxes + rng.uniform(5, 30, (40, 2))], 1).astype(np.float32)
    scores = np.round(rng.uniform(size=40), 1)             # many tied scores
    boxes[7] = boxes[3]                                     # a duplicate box
    for thresh in (0.0, 0.3, 0.5, 0.9):
        np.testing.assert_array_equal(THH.nms_boxes(boxes, scores, thresh),
                                      JHH.nms_boxes(boxes, scores, thresh))


class _StubPoseFront:
    """Fixed candidates in crop coordinates: two overlapping right hands with
    tied scores and a left hand (as tests/test_hand_multi.py's stub)."""

    def hand_candidates(self, crop01, conf_thresh=0.5):
        h, w = crop01.shape[:2]
        return [(np.asarray([w * 0.1, h * 0.1, w * 0.3, h * 0.3], np.float32), 0.9, True),
                (np.asarray([w * 0.12, h * 0.12, w * 0.31, h * 0.3], np.float32), 0.9, True),
                (np.asarray([w * 0.6, h * 0.6, w * 0.8, h * 0.8], np.float32), 0.8, False)]

    def hand_bbox(self, img01, is_right, conf_thresh=0.5):
        for box, _, side in self.hand_candidates(img01, conf_thresh):
            if side == is_right:
                return box
        return None


class _StubPersons:
    def __init__(self):
        self.calls = 0

    def person_boxes(self, img01, score_thresh=0.5):
        self.calls += 1
        return np.asarray([[0, 0, 95, 127], [96, 0, 191, 127], [10, 10, 20, 20]], np.float32)


def test_collect_hand_candidates_matches_the_reference():
    img = np.zeros((128, 192, 3), np.float32)
    persons = _StubPersons().person_boxes(img)
    for pb in (None, persons, persons[:1], np.zeros((0, 4), np.float32)):
        want = JHH.collect_hand_candidates(img, _StubPoseFront(), person_boxes=pb)
        got = THH.collect_hand_candidates(img, _StubPoseFront(), person_boxes=pb)
        assert [(s, r) for _, s, r in got] == [(s, r) for _, s, r in want]
        for (gb, _, _), (wb, _, _) in zip(got, want):
            np.testing.assert_array_equal(gb, wb)
    assert len(THH.collect_hand_candidates(img, _StubPoseFront(), person_boxes=persons)) == 4


def test_gdino_person_detector_matches_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path))
    write_gdino_vocab(str(tmp_path))
    p = gdino()
    img = two_person_frame(96, 128, seed=2).astype(np.float32) / 255.0
    want_det = JHH.GdinoPersonDetector(p.jax_model, p.params)
    got_det = THH.GdinoPersonDetector(p.torch_model)
    low = want_det.person_boxes(img, score_thresh=0.3)
    assert len(low) > 0
    boxes_close(got_det.person_boxes(img, score_thresh=0.3), low)
    boxes_close(got_det.person_boxes(img), want_det.person_boxes(img))
    assert THH.GdinoPersonDetector.maybe_build("cpu") is None
    assert THH.VitPoseFrontEnd.maybe_build("cpu") is None


@functools.lru_cache(maxsize=None)
def _jax_hamer_forward():
    jmodel, _, _ = _bridged_hamer()
    mano = JM.synthetic_mano()
    return jax.jit(lambda p, x: JMH.hamer_forward(jmodel, p, mano, x))


def _patch_jax_hamer(monkeypatch):
    """The JAX stage on the bridged parity HaMeR, its forward jitted."""
    jmodel, params, _ = _bridged_hamer()
    forward = _jax_hamer_forward()
    monkeypatch.setattr(JHH, "_build_model", lambda cfg: (jmodel, params))
    monkeypatch.setattr(JHH, "_default_config", lambda: jmodel.cfg)
    monkeypatch.setattr(JHH, "hamer_forward", lambda model, p, mano_model, x: forward(p, x))


def _jax_vitpose_without_init(monkeypatch, module):
    """The JAX front end's file read on a ``jax.eval_shape`` template (its
    load_or_init runs the model's init eagerly only for the tree's shapes)
    and its ViTPose forward jitted (eagerly, ~5 s here)."""
    def load_or_init(name, init_fn, seed=0):
        with open(JP.params_path(name), "rb") as f:
            return serialization.from_bytes(jax.eval_shape(init_fn, jax.random.key(seed)),
                                            f.read())

    apply = highest(module.apply)
    monkeypatch.setattr(JP, "load_or_init", load_or_init)
    monkeypatch.setattr(JVP.ViTPose, "apply", lambda self, params, x: apply(params, x))


def _assert_npy_match(got_dir, want_dir, name):
    want = np.load(os.path.join(want_dir, name), allow_pickle=True).item()
    got = np.load(os.path.join(got_dir, name), allow_pickle=True).item()
    assert sorted(got) == sorted(want), name
    for key in want:
        w, g = np.asarray(want[key]), np.asarray(got[key])
        assert g.shape == w.shape, (name, key, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=2e-4 * np.abs(w).max() + 1e-4,
                                   err_msg=f"{name} {key}")
    return got, want


def test_run_multi_hand_matches_the_reference(tmp_path, monkeypatch):
    """Two persons, each with a right and a left hand after the per-side NMS:
    four hands stacked, one OBJ each, in both packages."""
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path / "assets"))
    _patch_jax_hamer(monkeypatch)
    monkeypatch.setattr(JHH.VitPoseFrontEnd, "maybe_build",
                        classmethod(lambda cls: _StubPoseFront()))
    persons = {"jax": _StubPersons(), "torch": _StubPersons()}
    monkeypatch.setattr(JHH.GdinoPersonDetector, "maybe_build",
                        classmethod(lambda cls: persons["jax"]))
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    frame = np.random.default_rng(1).integers(0, 256, (128, 192, 3)).astype(np.uint8)
    Image.fromarray(frame).save(img_dir / "000011.png")
    out = {k: str(tmp_path / k) for k in ("jax", "torch")}
    with jax.default_matmul_precision("highest"):
        JHH.run(str(img_dir), out["jax"], multi_hand=True)
    THH.run(str(img_dir), out["torch"], multi_hand=True, model=_bridged_hamer()[2], pose_front=_StubPoseFront(),
            person_detector=persons["torch"], device="cpu")
    assert persons["jax"].calls == persons["torch"].calls == 1
    got, _ = _assert_npy_match(out["torch"], out["jax"], "000011.npy")
    _assert_npy_match(out["torch"], out["jax"], "000011_kps_for_guidance.npy")
    assert got["pred_vertices"].shape[0] == 4
    assert sorted(got["right"].tolist()) == [0.0, 0.0, 1.0, 1.0]
    assert sorted(os.listdir(out["torch"])) == sorted(os.listdir(out["jax"])) == [
        "000011.npy", *(f"000011_hamer_{k}.obj" for k in range(4)),
        "000011_kps_for_guidance.npy", "J_regressor_hamer.npy"]


def test_multi_hand_without_a_pose_file_takes_the_mask_box_and_says_so(tmp_path, monkeypatch,
                                                                      capsys):
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path / "assets"))
    img_dir, mask_dir = _write_crop(str(tmp_path), "000005", True, 11)
    out = str(tmp_path / "out")
    THH.run(img_dir, out, mask_dir=mask_dir, multi_hand=True, model=_bridged_hamer()[2],
            device="cpu")
    assert capsys.readouterr().out.count("no ViTPose file") == 1
    res = np.load(os.path.join(out, "000005.npy"), allow_pickle=True).item()
    np.testing.assert_array_equal(res["box_center"][0], [37.5, 33.5])   # the mask's box


def test_pipeline_mode_takes_the_keypoint_box_where_a_vitpose_file_exists(tmp_path,
                                                                          monkeypatch):
    """With a converted vitpose file both packages build the ViTPose front end
    in ``run`` and take the hand box from the crop side's keypoint block:
    the same box_center, box_size and outputs, and not the mask's box."""
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path / "assets"))
    module, params = _tiny_params(seed=22, hand_bias=_HAND_BIAS)
    JP.save_params("vitpose", params)
    monkeypatch.setattr(JVP, "ViTPoseConfig", lambda: JVP.VITPOSE_TINY)
    _jax_vitpose_without_init(monkeypatch, module)
    monkeypatch.setattr(TVP, "ViTPoseConfig", lambda: TVP.VITPOSE_TINY)
    _patch_jax_hamer(monkeypatch)
    img_dir, mask_dir = _write_crop(str(tmp_path), "000003", True, 7)
    out = {k: str(tmp_path / k) for k in ("jax", "torch")}
    with jax.default_matmul_precision("highest"):
        JHH.run(img_dir, out["jax"], mask_dir=mask_dir)
    THH.run(img_dir, out["torch"], mask_dir=mask_dir, model=_bridged_hamer()[2], device="cpu")
    got, want = _assert_npy_match(out["torch"], out["jax"], "000003.npy")
    _assert_npy_match(out["torch"], out["jax"], "000003_kps_for_guidance.npy")
    for key in ("box_center", "box_size"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, err_msg=key)
    mask_box = JHH._hand_bbox_from_mask(os.path.join(mask_dir, "000003_cropped_hand_mask.png"),
                                        (64, 64))
    mask_center = (mask_box[:2] + mask_box[2:]) / 2.0
    assert np.abs(got["box_center"][0] - mask_center).max() > 1.0, got["box_center"]
