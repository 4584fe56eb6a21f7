"""The port's text-prompted segmentation against the JAX package:
``models/swin.py``, ``models/bert.py``, ``models/gdino.py`` and
``models/sam2.py`` at the reference's tiny configurations in float32 on the
same weights (tests/_torch_detector_models.py: no JAX init runs, each JAX
apply is jitted once), the ConvTranspose rule of ``flax_to_torch``, and stage
2's learned path end to end: ``segment_hoi.hoi_detector`` through the port's
``LearnedBundle`` loading four converted files against a bundle built from the
JAX package's own host functions on the same arrays.

Both packages get the same input ids: a synthetic WordPiece vocabulary
(``tools/_scene.write_gdino_vocab``), since the JAX package's hashed fallback
is salted per process.

Tolerances:
- model outputs: 1e-4 * max|ref| + 1e-5 (float32 products summed in another
  order), -inf where the reference is -inf;
- final boxes in image pixels: 1e-3 px;
- masks: equal wherever the reference's logit lies further than 1e-4 from 0;
  the final masks, after PIL's resize to the image, equal outside the reach of
  the logits that changed sign (``_masks_agree_outside_flips``);
- the window helpers, the special-token masks and the ids: exactly.
"""

import dataclasses
import importlib.util
import os
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from followmyhold_tpu.models import bert as JB
from followmyhold_tpu.models import gdino as JG
from followmyhold_tpu.models import hand_object_detector as JR
from followmyhold_tpu.models import sam2 as JS
from followmyhold_tpu.models import swin as JW
from followmyhold_tpu.models import yolov8 as JY
from followmyhold_tpu.preprocess import detectors as JD
from followmyhold_tpu.preprocess import segment_hoi as JSEG
from followmyhold_tpu_torch.models import bert as TB
from followmyhold_tpu_torch.models import gdino as TG
from followmyhold_tpu_torch.models import hand_object_detector as TR
from followmyhold_tpu_torch.models import sam2 as TS
from followmyhold_tpu_torch.models import swin as TW
from followmyhold_tpu_torch.models import yolov8 as TY
from followmyhold_tpu_torch.preprocess import detectors as TD
from followmyhold_tpu_torch.preprocess import segment_hoi as TSEG
from followmyhold_tpu_torch.text.tokenizers import WordPieceTokenizer
from followmyhold_tpu_torch.tools._scene import hoi_photo, write_gdino_vocab
from followmyhold_tpu_torch.utils.params import flax_to_torch

from _torch_detector_models import (
    boxes_close,
    close,
    frcnn,
    gdino,
    highest,
    masks_agree,
    random_params,
    sam2,
    yolo,
)

TINY = {"yolo": TY.YOLOV8_TINY_TEST, "frcnn": TR.FRCNN_TINY, "gdino": TG.GDINO_TINY,
        "sam2": TS.SAM2_TINY_TEST}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def vocab(tmp_path, monkeypatch):
    """A temporary FOHO_TPU_ASSETS holding the synthetic GroundingDINO vocabulary."""
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path / "assets"))
    return WordPieceTokenizer.from_vocab_file(write_gdino_vocab(str(tmp_path / "assets")))


def _ids(tok, caption="only hand."):
    return tok.encode(caption, max_len=256)


def _crop(size=96, seed=1):
    return hoi_photo(size, size, seed=seed)


def _reach(index: int, n_in: int, n_out: int) -> np.ndarray:
    """The rows (or columns) of a PIL bicubic resize from n_in to n_out that
    row ``index`` of its input weighs in: within the filter's support of 2
    input pixels, widened by the reduction, of their centre, and one more."""
    scale = n_in / n_out
    centre = (np.arange(n_out) + 0.5) * scale
    return np.abs(centre - (index + 0.5)) <= 2.0 * max(scale, 1.0) + 1.0


def _masks_agree_outside_flips(got: np.ndarray, want: np.ndarray,
                               got_logits: np.ndarray, want_logits: np.ndarray) -> None:
    """segment_box's final masks (its logits > 0, resized by PIL to the image)
    equal at every pixel that no logit of another sign reaches."""
    assert got.shape == want.shape
    flipped = (got_logits > 0) != (want_logits > 0)
    reached = np.zeros(got.shape, bool)
    for i, j in zip(*np.nonzero(flipped)):
        reached |= np.outer(_reach(i, flipped.shape[0], got.shape[0]),
                            _reach(j, flipped.shape[1], got.shape[1]))
    np.testing.assert_array_equal(got[~reached], want[~reached])


# ---- Swin and BERT ------------------------------------------------------ #

def test_window_helpers_are_exact():
    for w, hp, wp, shift in ((4, 12, 16, 2), (12, 36, 36, 6), (12, 108, 108, 6)):
        np.testing.assert_array_equal(TW._relative_position_index(w),
                                      JW._relative_position_index(w))
        np.testing.assert_array_equal(TW._shift_attn_mask(hp, wp, w, shift),
                                      JW._shift_attn_mask(hp, wp, w, shift))


@pytest.mark.parametrize("depths", [(1, 1, 1), (2, 2, 1)], ids=["tiny", "shifted"])
def test_swin_backbone_matches_the_reference(depths, monkeypatch):
    """At 40x56 every stage pads (10x14 to 12x16 with window 4); the second
    blocks of (2, 2, 1) shift their windows. The reference builds its shift
    mask with numpy from a jnp array, which a jit trace refuses, so its own
    ``_shift_attn_mask`` runs here with constants evaluated eagerly
    (``jax.ensure_compile_time_eval``)."""
    reference_mask = JW._shift_attn_mask

    def concrete_mask(*args):
        with jax.ensure_compile_time_eval():
            return reference_mask(*args)

    monkeypatch.setattr(JW, "_shift_attn_mask", concrete_mask)
    jcfg = dataclasses.replace(JW.SWIN_TINY_TEST, depths=depths)
    tcfg = dataclasses.replace(TW.SWIN_TINY_TEST, depths=depths)
    m = JW.SwinBackbone(jcfg)
    x = np.random.default_rng(20).normal(size=(1, 40, 56, 3)).astype(np.float32)
    params = random_params(lambda k: m.init(k, jnp.zeros(x.shape)), 21)
    want = highest(m.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = flax_to_torch(params, TW.SwinBackbone(tcfg, device="cpu"))(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(1, 5, 7, 32), (1, 3, 4, 64)]
    for g, w in zip(got, want):
        close(g, w, "swin")


def test_special_token_masks_match_the_reference():
    ids = np.array([[101, 1200, 1201, 1012, 1300, 1029, 1301, 1302, 1012, 102],
                    [101, 1200, 102, 0, 0, 0, 0, 0, 0, 0]])
    for got, want in zip(TG.generate_special_token_masks(ids),
                         JG.generate_special_token_masks(ids)):
        np.testing.assert_array_equal(got, want)


def test_bert_matches_the_reference():
    ids = np.array([[101, 1200, 1201, 1012, 1300, 1301, 1012, 102]])
    attn, pos = JG.generate_special_token_masks(ids)
    m = JB.BertModel(JB.BERT_TINY_TEST)
    params = random_params(lambda k: m.init(k, jnp.zeros(ids.shape, jnp.int32)), 22)
    want = highest(m.apply)(params, jnp.asarray(ids), jnp.asarray(attn), None,
                            jnp.asarray(pos))
    with torch.no_grad():
        got = flax_to_torch(params, TB.BertModel(TB.BERT_TINY_TEST, device="cpu"))(
            torch.from_numpy(ids), torch.from_numpy(attn), None, torch.from_numpy(pos))
    close(got, want, "bert")


# ---- GroundingDINO ------------------------------------------------------ #

def test_grid_sample_zeros_matches_the_reference():
    rng = np.random.default_rng(23)
    value = rng.normal(size=(3, 5, 7, 4)).astype(np.float32)
    gx, gy = (rng.uniform(-1.3, 1.3, (3, 40)).astype(np.float32) for _ in range(2))
    want = JG._grid_sample_zeros(jnp.asarray(value), jnp.asarray(gx), jnp.asarray(gy))
    got = TG._grid_sample_zeros(*(torch.from_numpy(a) for a in (value, gx, gy)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_grounding_dino_matches_the_reference(vocab):
    p = gdino()
    kwargs = TG.preprocess_inputs(_crop(), _ids(vocab), TG.GDINO_TINY.image_size)
    want = p.jax_model.apply(p.params, **{k: jnp.asarray(v.numpy())
                                          for k, v in kwargs.items()})
    with torch.no_grad():
        got = p.torch_model(**kwargs)
    assert set(got) == set(want)
    assert got["logits"].shape == (1, 12, 16) and got["pred_boxes"].shape == (1, 12, 4)
    for key in sorted(want):
        close(got[key], want[key], key)


def test_detect_text_prompt_and_tokenizing_match_the_reference(vocab, tmp_path):
    np.testing.assert_array_equal(TG.tokenize_prompt("Only hand"),
                                  JG.tokenize_prompt("Only hand"))
    p = gdino()
    want = JG.detect_text_prompt(p.jax_model, p.params, _crop(), "only hand")
    got = TG.detect_text_prompt(p.torch_model, _crop(), "only hand")
    assert len(want[0]) > 0
    boxes_close(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)

    # without a vocabulary: a converted gdino file makes the hashed ids an error
    os.remove(os.path.join(os.environ["FOHO_TPU_ASSETS"], "tokenizers", "gdino", "vocab.txt"))
    os.makedirs(tmp_path / "assets" / "params")
    (tmp_path / "assets" / "params" / "gdino.msgpack").write_bytes(b"")
    with pytest.raises(RuntimeError, match="no BERT vocab"):
        TG.tokenize_prompt("only hand")
    os.environ["FOHO_ALLOW_HASH_TOKENIZER"] = "1"
    try:
        ids = TG.tokenize_prompt("only hand")
    finally:
        del os.environ["FOHO_ALLOW_HASH_TOKENIZER"]
    assert ids.shape == (1, 5) and ids[0, 0] == 101 and ids[0, 3] == 1012


def test_detect_phase_reads_gdino_outputs_by_its_rule():
    """chip_smoke.py's detect phase: GroundingDINO's logits may be -inf (the
    text's padding) and its unread encoder coordinates +inf; anything else
    non-finite fails, and the largest |output| is taken over finite entries."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    inf = float("inf")
    out = {"logits": torch.tensor([[-3.0, -inf]]), "pred_boxes": torch.tensor([[0.5, -7.0]]),
           "encoder_text": torch.zeros(2), "encoder_vision": torch.ones(2),
           "encoder_coords": torch.tensor([inf])}
    assert smoke._outputs_finite("gdino", out)
    assert smoke._largest_output("gdino", out) == 7.0
    for name, bad in (("logits", inf), ("pred_boxes", -inf), ("encoder_vision", float("nan"))):
        broken = dict(out, **{name: torch.tensor([bad])})
        assert not smoke._outputs_finite("gdino", broken), name
    sam = (torch.tensor([[2.0, -inf]]), torch.tensor([0.5]))
    assert not smoke._outputs_finite("sam2", sam)
    assert smoke._largest_output("sam2", sam) == 2.0
    assert smoke._outputs_finite("frcnn", {"rois": torch.tensor([-9.0])})
    assert smoke._largest_output("frcnn", {"rois": torch.tensor([-9.0])}) == 9.0


# ---- SAM2 --------------------------------------------------------------- #

@pytest.mark.parametrize("thresh", [0.0, 1.01], ids=["stable", "unstable"])
def test_sam2_matches_the_reference_on_both_branches(thresh):
    """Every mask passes a threshold of 0 and none passes 1.01, so token 0's
    mask and the best multimask token's are each taken."""
    p = sam2(thresh)
    rng = np.random.default_rng(24)
    image = rng.uniform(size=(2, 128, 128, 3)).astype(np.float32)
    boxes = np.array([[0.1, 0.2, 0.6, 0.7], [0.3, 0.05, 0.95, 0.5]], np.float32)
    want_logits, want_iou = p.jax_model.apply(p.params, jnp.asarray(image), jnp.asarray(boxes))
    with torch.no_grad():
        logits, iou = p.torch_model(torch.from_numpy(image), torch.from_numpy(boxes))
    assert logits.shape == (2, 128, 128) and iou.shape == (2,)
    close(logits, want_logits, "logits")
    close(iou, want_iou, "iou")


def test_segment_box_matches_the_reference():
    p = sam2()
    want_logits, got_logits = [], []
    apply = p.jax_model.apply

    def recording(*args):
        out = apply(*args)
        want_logits.append(np.asarray(out[0][0]))
        return out

    stand_in = types.SimpleNamespace(cfg=p.jax_model.cfg, apply=recording)
    hook = p.torch_model.register_forward_hook(
        lambda m, a, out: got_logits.append(out[0][0].numpy()))
    try:
        image, box = _crop(), np.array([10.0, 20.0, 70.0, 80.0], np.float32)
        want = JS.segment_box(stand_in, p.params, image, box)
        got = TS.segment_box(p.torch_model, image, box)
    finally:
        hook.remove()
    (g,), (w,) = got_logits, want_logits
    masks_agree(g > 0, w > 0, w)
    assert got.shape == (96, 96) and got.any() and not got.all()
    _masks_agree_outside_flips(got, want, g, w)


# ---- the parameter bridge ----------------------------------------------- #

@pytest.mark.parametrize("cin,cout", [(5, 3), (4, 4)], ids=["256to64-like", "square"])
def test_conv_transpose_bridge_flips_the_kernel(cin, cout):
    layer = fnn.ConvTranspose(cout, (2, 2), strides=(2, 2))
    x = np.random.default_rng(25).normal(size=(1, 3, 4, cin)).astype(np.float32)
    params = random_params(lambda k: layer.init(k, jnp.zeros(x.shape)), 26)
    want = highest(layer.apply)(params, jnp.asarray(x))
    holder = torch.nn.Module()
    holder.up = torch.nn.ConvTranspose2d(cin, cout, 2, stride=2)
    flax_to_torch({"params": {"up": params["params"]}}, holder)
    with torch.no_grad():
        got = holder.up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    kernel = params["params"]["kernel"]
    np.testing.assert_array_equal(holder.up.weight.detach().numpy(),
                                  kernel[::-1, ::-1].transpose(2, 3, 0, 1))
    # a single one spreads into the kernel flipped in space
    one = np.zeros((1, 1, 1, cin), np.float32)
    one[..., 0] = 1.0
    spread = np.asarray(layer.apply(params, jnp.asarray(one)))[0, :, :, 0]
    np.testing.assert_allclose(spread - params["params"]["bias"][0],
                               kernel[::-1, ::-1, 0, 0], rtol=0, atol=1e-6)


# ---- stage 2's learned path --------------------------------------------- #

class _JaxLearnedBundle:
    """The JAX package's LearnedBundle, duck-typed on the shared arrays and
    jitted applies: its detect_hands, detect_hand_object and segment, built
    from the package's own host functions."""

    def __init__(self, sam_logits: list):
        self.y, self.r, self.g, s = yolo(), frcnn(), gdino(), sam2()
        apply = s.jax_model.apply

        def recording(*args):
            out = apply(*args)
            sam_logits.append(np.asarray(out[0][0]))
            return out

        self.s = (types.SimpleNamespace(cfg=s.jax_model.cfg, apply=recording), s.params)

    def detect_hands(self, image_rgb):
        return [JD.Detection(box_xyxy=d["box"], score=d["score"], is_right=d["is_right"])
                for d in JY.detect_hands_yolov8(self.y.jax_model, self.y.params, image_rgb)]

    def detect_hand_object(self, image_rgb):
        return JR.detect_hand_object(self.r.jax_model, self.r.params, image_rgb)

    def segment(self, image_rgb, prompt):
        boxes, _ = JG.detect_text_prompt(self.g.jax_model, self.g.params, image_rgb, prompt)
        mask = np.zeros(image_rgb.shape[:2], bool)
        for box in boxes[:1]:
            mask |= JS.segment_box(*self.s, image_rgb, box)
        return mask


def _write_params(assets: str) -> None:
    """The four converted files, as the JAX package's converters write them."""
    os.makedirs(os.path.join(assets, "params"), exist_ok=True)
    for name, pair in zip(TD.LEARNED_PARAMS, (yolo(), frcnn(), gdino(), sam2())):
        with open(os.path.join(assets, "params", f"{name}.msgpack"), "wb") as f:
            f.write(serialization.to_bytes(pair.params))


def test_stage_2_learned_path_matches_the_reference(vocab, tmp_path, monkeypatch):
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    assets = os.environ["FOHO_TPU_ASSETS"]
    _write_params(assets)
    bundle = TD.LearnedBundle(device="cpu", configs=TINY)
    for model, pair in ((bundle.yolo, yolo()), (bundle.frcnn, frcnn()),
                        (bundle.gdino, gdino()), (bundle.sam, sam2())):
        for name, value in pair.torch_model.state_dict().items():
            np.testing.assert_array_equal(model.state_dict()[name].numpy(), value.numpy())

    sam_logits, got_logits = [], []
    bundle.sam.register_forward_hook(lambda m, a, out: got_logits.append(out[0][0].numpy()))
    photo = hoi_photo(96, 128, seed=0)
    want = JSEG.hoi_detector(photo, _JaxLearnedBundle(sam_logits), object_name="striped box")
    got = TSEG.hoi_detector(photo, bundle, object_name="striped box", device="cpu")

    assert got["is_right"] == want["is_right"]
    np.testing.assert_allclose(got["bbox_xywh"], want["bbox_xywh"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["transform"], want["transform"], rtol=0, atol=1e-5)
    assert np.abs(got["cropped_hoi"].astype(int) - want["cropped_hoi"].astype(int)).max() <= 1
    # the crops differ by one level in some pixels (the warp's rounding), so the
    # segmenters see other inputs: the check is the logits within 1e-2 max|ref|,
    # and the final masks equal wherever no logit that changed sign reaches
    assert len(got_logits) == len(sam_logits) == 2          # the object, then the hand
    for name, g, w in zip(("obj_mask", "hand_mask"), got_logits, sam_logits):
        diff = np.abs(g - w).max()
        assert diff <= 1e-2 * np.abs(w).max(), (name, diff, np.abs(w).max())
        assert got[name].shape == want[name].shape == got["cropped_hoi"].shape[:2]
        assert got[name].any(), name
        _masks_agree_outside_flips(got[name], want[name], g, w)


def test_default_bundle_learns_only_with_all_four_files(tmp_path, monkeypatch):
    assets = str(tmp_path / "assets")
    monkeypatch.setenv("FOHO_TPU_ASSETS", assets)
    built = []
    real = TD.LearnedBundle

    def tiny_bundle(device="cuda"):
        built.append(device)
        return real(device=device, configs=TINY)

    monkeypatch.setattr(TD, "LearnedBundle", tiny_bundle)
    _write_params(assets)
    os.remove(os.path.join(assets, "params", "sam2.msgpack"))
    assert isinstance(TD.default_bundle("cpu"), TD.HeuristicBundle) and not built
    _write_params(assets)
    bundle = TD.default_bundle("cpu")
    assert built == ["cpu"] and isinstance(bundle, real)
    hands = bundle.detect_hands(hoi_photo(96, 128, seed=0))
    assert all(np.isfinite(h.box_xyxy).all() for h in hands)
