"""Stages 1-2 and the orchestrator of the PyTorch port (``configs/pipeline``,
``utils/artifacts``, the box and resize helpers of ``ops/image``,
``preprocess/{gemini_objname,detectors,segment_hoi,get_hunyuan_input}`` and
``main.run_pipeline``) against the JAX package, on the same env files and on
synthetic photos of a hand holding an object (``tools._scene.hoi_photo``).

Stages 3-9 have parity tests of their own; here the port's ``run_pipeline``
runs them once end to end at ``FOHO_TPU_PROFILE=tiny`` (the ICP sample
counts cut as in ``test_torch_icp``), with the artifact, PLY and resume
checks of ``tests/test_pipeline_e2e.py``. The module runs on one torch
thread (see ``test_torch_guidance_batch``).

Tolerances (measured on the CPU with these photos):
- the configuration, the artifact names, the Gemini CSV and the original
  photo: exactly;
- ``box_iou``, ``process_bbox``, ``normalize_imagenet``: 1e-6; the
  bilinear resize: 1e-5 of the largest input (the linear resize's weights,
  summed in another order, as ``test_torch_moge``);
- the crop's is_right exactly, its box and 3x3 transform to 1e-6 (the same
  float64 solve, rounded to float32 alike);
- the crops within one grey level: both packages warp in float32 and
  truncate to uint8, and a value within rounding of an integer lands on
  either side (measured: 0 on the first photo, 1 on 1.09 % of the second's
  values);
- the masks, which the heuristic segmenter computes from those crops: the
  share of pixels that differ at most ``MASK_SHARE`` (measured 0 on both
  photos: the 64^2 crop's one-level steps move no threshold), and the
  composed images within one grey level where both masks agree.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from followmyhold_tpu.configs import pipeline as JCFG
from followmyhold_tpu.ops import image as JI
from followmyhold_tpu.preprocess import detectors as JD
from followmyhold_tpu.preprocess import gemini_objname as JGEM
from followmyhold_tpu.preprocess import get_hunyuan_input as JGHI
from followmyhold_tpu.preprocess import segment_hoi as JSEG
from followmyhold_tpu.utils import artifacts as JART
from followmyhold_tpu_torch import main as TMAIN
from followmyhold_tpu_torch.alignment import h2m as TH2M
from followmyhold_tpu_torch.alignment import mano as TMA
from followmyhold_tpu_torch.alignment import mesh_align as TMAL
from followmyhold_tpu_torch.configs import load_config, paths as TPATHS, pipeline as TCFG
from followmyhold_tpu_torch.ops import image as TI
from followmyhold_tpu_torch.preprocess import detectors as TD
from followmyhold_tpu_torch.preprocess import gemini_objname as TGEM
from followmyhold_tpu_torch.preprocess import get_hunyuan_input as TGHI
from followmyhold_tpu_torch.preprocess import segment_hoi as TSEG
from followmyhold_tpu_torch.tools._scene import hoi_photo
from followmyhold_tpu_torch.utils import artifacts as TART
from followmyhold_tpu_torch.utils.mesh_io import load_mesh

# the share of mask pixels that may differ between the packages: twice the
# largest measured share, which is 0 on both photos, so the floor rules: 4
# pixels of a 64^2 crop, for a one-level step of the crop that crosses one of
# the segmenter's thresholds on another CPU
MASK_SHARE = 4 / 64 ** 2

# the ICP's sample counts and iterations, cut as in test_torch_icp
_SMALL_ICP = dict(count_source_coarse=200, count_target_coarse=600, iterations_coarse=15,
                  count_source_fine=400, count_target_fine=900, iterations_fine=20)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The tiny profile, no converted files, no Gemini key."""
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path / "no_assets"))
    monkeypatch.delenv("GEMINI_API_KEY", raising=False)


# ---- the configuration and the artifact names --------------------------- #

_ENV_FILES = {
    "minimal": "PROJECT_ROOT=/p\nBASE_DIR=/b\nIMAGE_PATH=/i/000001.png\n",
    "comments_quotes_overrides": (
        "# the pipeline's env file\n\n"
        "  PROJECT_ROOT = \"/proj root\"  \n"
        "BASE_DIR='/base'\n"
        "SPLIT_PATH=/splits/test.csv\n"
        "IMAGE_PATH=\n"
        "a line without an equals sign\n"
        "# MOGE_OUT_PATH=/commented/out\n"
        "MOGE_OUT_PATH=/elsewhere/moge\n"
        "GUIDANCE_OUT_PATH=\"/g\"\n"
        "GEMINI_RESPONSES=/b/names.csv\n"
        "RUN_INPAINT=0\n"
        "FOHO_SUPPRESS_WARNINGS=0\n"
        "GEMINI_API_KEY='k=v'\n"
        "HF_TOKEN=hf\nHY3DGEN_MODELS=/models\n"
        "MESH_SHAPE=dp=4,tp=2\n"
        "FOHO_TPU_ASSETS=/assets\n"),
}
_ENV_ERRORS = {
    "no_base_dir": ("PROJECT_ROOT=/p\nIMAGE_PATH=/i.png\n", ValueError,
                    "PROJECT_ROOT and BASE_DIR"),
    "no_images": ("PROJECT_ROOT=/p\nBASE_DIR=/b\nSPLIT_PATH=\n", ValueError,
                  "SPLIT_PATH or IMAGE_PATH"),
}


@pytest.mark.parametrize("name", sorted(_ENV_FILES))
def test_load_config_and_artifacts_match_the_reference(tmp_path, name):
    path = tmp_path / "pipeline.env"
    path.write_text(_ENV_FILES[name])
    want, got = JCFG.load_config(str(path)), load_config(str(path))
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.output_dirs() == want.output_dirs()
    assert TCFG._parse_env_file(str(path)) == JCFG._parse_env_file(str(path))
    for is_right, ext in ((True, ".png"), (False, ".jpg")):
        a_want = JART.artifacts_for(want, "000007", is_right, ext)
        a_got = TART.artifacts_for(got, "000007", is_right, ext)
        assert dataclasses.asdict(a_got) == dataclasses.asdict(a_want)
        assert a_got.guidance_done() is False


@pytest.mark.parametrize("name", sorted(_ENV_ERRORS))
def test_load_config_refuses_what_the_reference_refuses(tmp_path, name):
    text, error, match = _ENV_ERRORS[name]
    path = tmp_path / "pipeline.env"
    path.write_text(text)
    with pytest.raises(error, match=match):
        JCFG.load_config(str(path))
    with pytest.raises(error, match=match):
        load_config(str(path))
    with pytest.raises(FileNotFoundError, match="Missing config"):
        load_config(str(tmp_path / "absent.env"))


def test_paths_name_the_port_and_its_checkout():
    root = TPATHS.repo_root()
    assert TPATHS.package_root() == os.path.join(root, "followmyhold_tpu_torch")
    assert os.path.isfile(os.path.join(root, "followmyhold_tpu_torch", "main.py"))


# ---- the box and resize helpers ---------------------------------------- #

def test_box_helpers_and_normalisation_match_the_reference():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 50, (64, 2)).astype(np.float32)
    b = rng.uniform(0, 50, (64, 2)).astype(np.float32)
    box1 = np.concatenate([a, a + rng.uniform(0, 30, (64, 2)).astype(np.float32)], 1)
    box2 = np.concatenate([b, b + rng.uniform(0, 30, (64, 2)).astype(np.float32)], 1)
    box2[0] = box1[0]                       # the same box
    box2[1] = [200, 200, 210, 210]          # disjoint
    box1[2, 2:] = box1[2, :2]               # no area
    box2[2] = box1[2]                       # an empty union
    want = np.asarray(JI.box_iou(jnp.asarray(box1), jnp.asarray(box2)))
    got = TI.box_iou(torch.from_numpy(box1), torch.from_numpy(box2)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[0] == pytest.approx(1.0) and got[1] == 0.0 and got[2] == 0.0
    # broadcasting [N,1,4] x [1,M,4]
    np.testing.assert_allclose(
        TI.box_iou(torch.from_numpy(box1)[:, None], torch.from_numpy(box2)[None]).numpy(),
        np.asarray(JI.box_iou(jnp.asarray(box1)[:, None], jnp.asarray(box2)[None])), atol=1e-6)
    for box, factor in (([3.0, 4.0, 20.0, 10.0], 1.25), ([0.5, 7.25, 9.0, 30.0], 2.0)):
        np.testing.assert_allclose(TI.process_bbox(box, factor), JI.process_bbox(box, factor),
                                   atol=1e-6)
    img = rng.uniform(size=(5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(TI.normalize_imagenet(torch.from_numpy(img)).numpy(),
                               np.asarray(JI.normalize_imagenet(jnp.asarray(img))), atol=1e-6)


@pytest.mark.parametrize("shape,out_hw", [((20, 30, 3), (48, 17)), ((40, 24), (12, 60)),
                                          ((9, 9, 1), (9, 20))])
def test_resize_bilinear_matches_the_reference(shape, out_hw):
    img = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(JI.resize_bilinear(jnp.asarray(img), out_hw))
    got = TI.resize_bilinear(torch.from_numpy(img), out_hw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(img).max())
    as_uint8 = TI.resize_bilinear(torch.from_numpy(img.astype(np.uint8)), out_hw)
    assert as_uint8.dtype == torch.float32


# ---- stages 1 and 2 ----------------------------------------------------- #

def _photos(root):
    """Two photos (a 1280x960 and a 960x720 one, other seeds) and a split
    CSV of them plus a missing one; the first row names its object."""
    rows = []
    for k, (h, w) in enumerate(((960, 1280), (720, 960))):
        path = os.path.join(root, f"photo_{k}.png")
        Image.fromarray(hoi_photo(h, w, seed=k)).save(path)
        rows.append((f"00010{k}", path, "striped box" if k == 0 else ""))
    rows.append(("000109", os.path.join(root, "missing.png"), ""))
    split = os.path.join(root, "split.csv")
    with open(split, "w", encoding="utf-8") as f:
        f.write("img_id,img_path,object\n" + "".join(f"{i},{p},{o}\n" for i, p, o in rows))
    return split, rows


def _stage2_dirs(root):
    return [os.path.join(root, k) for k in ("occ", "crops", "crops_wo_bg", "masks", "orig")]


def _read(path):
    return np.asarray(Image.open(path))


def test_hoi_detector_matches_the_reference(tiny, tmp_path):
    for k, (h, w) in enumerate(((960, 1280), (720, 960))):
        img = hoi_photo(h, w, seed=k)
        want = JSEG.hoi_detector(img, JD.HeuristicBundle(), object_name="box")
        got = TSEG.hoi_detector(img, TD.HeuristicBundle(), object_name="box", device="cpu")
        assert got["is_right"] == want["is_right"]
        np.testing.assert_allclose(got["bbox_xywh"], want["bbox_xywh"], atol=1e-6)
        np.testing.assert_allclose(got["transform"], want["transform"], atol=1e-6)
        crop_diff = np.abs(got["cropped_hoi"].astype(int) - want["cropped_hoi"].astype(int))
        assert got["cropped_hoi"].shape == (64, 64, 3) and crop_diff.max() <= 1
        for name in ("obj_mask", "hand_mask"):
            assert got[name].dtype == bool and got[name].any(), name
            assert (got[name] != want[name]).mean() <= MASK_SHARE, name


def test_stages_1_and_2_write_what_the_reference_writes(tiny, tmp_path, capfd):
    split, rows = _photos(str(tmp_path))
    csv = {name: str(tmp_path / name / "gemini.csv") for name in ("jax", "port")}
    JGEM.run(csv["jax"], split_path=split)
    TGEM.run(csv["port"], split_path=split)
    with open(csv["jax"], "rb") as f, open(csv["port"], "rb") as g:
        want_csv = f.read()
        assert g.read() == want_csv
    assert b"striped box" in want_csv and want_csv.count(b"object") == 2
    TGEM.run(csv["port"], split_path=split)                  # every row there: nothing added
    with open(csv["port"], "rb") as g:
        assert g.read() == want_csv

    dirs = {name: _stage2_dirs(str(tmp_path / name)) for name in ("jax", "port")}
    JGHI.run(*dirs["jax"], split_path=split, gemini_responses=csv["jax"])
    capfd.readouterr()
    TGHI.run(*dirs["port"], split_path=split, gemini_responses=csv["port"], device="cpu")
    out = capfd.readouterr()
    assert "Error processing 000109" in out.out and "Traceback" in out.err
    for d_want, d_got in zip(dirs["jax"], dirs["port"]):
        assert sorted(os.listdir(d_got)) == sorted(os.listdir(d_want))
    occ, crops, crops_wo_bg, masks, orig = dirs["port"]
    for image_id, _, _ in rows[:2]:
        w_occ, w_crops, w_wo_bg, w_masks, w_orig = dirs["jax"]
        np.testing.assert_array_equal(_read(os.path.join(orig, f"{image_id}.png")),
                                      _read(os.path.join(w_orig, f"{image_id}.png")))
        np.testing.assert_allclose(
            np.load(os.path.join(masks, f"{image_id}_crop_transform.npy")),
            np.load(os.path.join(w_masks, f"{image_id}_crop_transform.npy")), atol=1e-6)
        name = f"{image_id}_cropped_hoi_1.png"      # the heuristic's right hand
        crop, w_crop = _read(os.path.join(crops, name)), _read(os.path.join(w_crops, name))
        assert np.abs(crop.astype(int) - w_crop.astype(int)).max() <= 1
        agree = np.ones(crop.shape[:2], bool)
        for part in ("obj", "hand"):
            mask_name = f"{image_id}_cropped_{part}_mask.png"
            got, want = _read(os.path.join(masks, mask_name)), _read(os.path.join(w_masks,
                                                                                 mask_name))
            assert got.any() and set(np.unique(got)) <= {0, 255}
            assert (got != want).mean() <= MASK_SHARE, mask_name
            agree &= got == want
        for d, w_d, img_name in ((occ, w_occ, f"{image_id}_masked_obj.png"),
                                 (crops_wo_bg, w_wo_bg, name)):
            got, want = _read(os.path.join(d, img_name)), _read(os.path.join(w_d, img_name))
            assert np.abs(got.astype(int) - want.astype(int))[agree].max() <= 1, img_name

    # a photo whose crop exists is skipped
    before = os.path.getmtime(os.path.join(crops, f"{rows[0][0]}_cropped_hoi_1.png"))
    TGHI.run(*dirs["port"], split_path=split, gemini_responses=csv["port"], device="cpu")
    assert f"{rows[0][0]} exists, skipping" in capfd.readouterr().out
    assert os.path.getmtime(os.path.join(crops, f"{rows[0][0]}_cropped_hoi_1.png")) == before


def test_the_learned_bundle_raises_where_its_files_exist(tmp_path, monkeypatch):
    """With the four files present the learned bundle is chosen, and a file
    that does not load raises: nothing falls back to the heuristics."""
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path))
    assert isinstance(TD.default_bundle(), TD.HeuristicBundle)
    os.makedirs(tmp_path / "params")
    for name in TD.LEARNED_PARAMS:
        (tmp_path / "params" / f"{name}.msgpack").write_bytes(b"")
    assert TD.LEARNED_PARAMS == ("yolov8_wilor", "hand_object_detector", "gdino", "sam2")
    with pytest.raises(ValueError, match="yolov8_wilor.msgpack is empty"):
        TD.default_bundle("cpu")


# ---- the orchestrator --------------------------------------------------- #

def _cut_icp(monkeypatch):
    for module in (TH2M, TMA):
        monkeypatch.setattr(module, "align_meshes_impl",
                            lambda *a, **k: TMAL.align_meshes_impl(*a, **{**k, **_SMALL_ICP}))


def test_run_pipeline_runs_stages_1_to_9_and_resumes(tiny, tmp_path, monkeypatch, capsys):
    _cut_icp(monkeypatch)
    photo = tmp_path / "000001.png"
    Image.fromarray(hoi_photo()).save(photo)
    base = tmp_path / "out"
    cfg_path = tmp_path / "pipeline.env"
    cfg_path.write_text(f"PROJECT_ROOT={tmp_path}\nBASE_DIR={base}\nIMAGE_PATH={photo}\n"
                        "RUN_INPAINT=1\n")
    cfg = load_config(str(cfg_path))
    TMAIN.run_pipeline(cfg, device="cpu")
    said = capsys.readouterr().out
    assert "Error" not in said, said

    image_id = "000001"
    art = TART.artifacts_for(cfg, image_id, is_right=True)
    for path in (art.original_img, art.masked_obj_img, art.cropped_hoi, art.cropped_hoi_wo_bckg,
                 art.cropped_obj_mask, art.cropped_hand_mask, art.inpainted_obj, art.moge_fov,
                 art.moge_mesh, art.hunyuan_hoi_mesh, art.hamer_npy, art.hamer_kps,
                 art.hamer_mesh, art.h2m_transform, art.aligned_mano_mesh, art.guidance_obj,
                 art.guidance_hand, os.path.join(base, "gemini_responses.csv")):
        assert os.path.exists(path), path
    for mask in (art.cropped_obj_mask, art.cropped_hand_mask):
        assert _read(mask).any(), mask
    obj, hand = load_mesh(art.guidance_obj), load_mesh(art.guidance_hand)
    assert obj.num_vertices > 0 and hand.num_vertices == 778
    assert np.isfinite(obj.vertices).all() and np.isfinite(hand.vertices).all()
    T = np.load(art.h2m_transform)
    assert T.shape == (4, 4)
    np.testing.assert_allclose(T[3], [0, 0, 0, 1], atol=1e-5)

    # a second run skips every image of every stage and rewrites no artifact
    # (stage 6 writes J_regressor_hamer.npy on every call, as the reference does)
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(base) for f in fs)
    stamps = {f: os.path.getmtime(f) for f in files if "J_regressor" not in f}
    TMAIN.run_pipeline(cfg, device="cpu")
    said = capsys.readouterr().out
    assert said.count("skipping") >= 8 and "Error" not in said, said
    assert sorted(os.path.join(d, f) for d, _, fs in os.walk(base) for f in fs) == files
    assert {f: os.path.getmtime(f) for f in stamps} == stamps


def test_main_reads_the_env_file_and_the_device(tmp_path, monkeypatch):
    cfg_path = tmp_path / "pipeline.env"
    cfg_path.write_text("PROJECT_ROOT=/p\nBASE_DIR=/b\nIMAGE_PATH=/i.png\n")
    seen, run_pipeline = {}, TMAIN.run_pipeline
    monkeypatch.setattr(TMAIN, "run_pipeline", lambda cfg, device: seen.update(cfg=cfg,
                                                                                device=device))
    monkeypatch.setattr("sys.argv", ["main", "--config", str(cfg_path), "--device", "cpu"])
    TMAIN.main()
    assert seen == {"cfg": load_config(str(cfg_path)), "device": "cpu"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_pipeline(load_config(str(cfg_path)))
