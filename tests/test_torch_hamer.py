"""The hand stage of the PyTorch port (HaMeR: rotations, cameras, the patch
crop, MANO skinning, the ViT-H backbone's padded patch embedding and cls
slot, the decoder head, and ``hand/hamer.run``) against the JAX package, on
the same numpy inputs and, through ``flax_to_torch``, the same weights.

HaMeR's configuration here is small but consistent: a 256x256 crop cut to
the backbone's 256x192 (both packages cut 32 columns), a one-block backbone
of width 32 with HaMeR's 2-px patch padding and cls slot, and a one-layer
head. The reference's tiny profile has a 64-px crop, from which its fixed
32-column cut leaves the backbone no column at all; the port cuts to the
backbone's width (8 columns there), so under ``FOHO_TPU_PROFILE=tiny`` its own
run is checked alone.

Tolerances, float32 on both sides (measured on the CPU with these seeds):
- rotations and cameras: 1e-5 absolute (the projection's pixels also 1e-6
  relative); measured 0 for every rotation, <= 1.2e-7 for the cameras
  (5.5e-8 relative for pixels of order 300);
- the patch crop: 1e-5 on [0, 1] pixels (the same bilinear taps in the same
  order; the inverse affine is solved by each library's own LU); measured 0;
- ``mano_forward``: 2e-5 absolute (sums over 16 joints of 4x4 products);
  measured 2.4e-7;
- the backbone and the head: 2e-4 absolute on LayerNorm-ed features, as the
  conditioner's tests; measured 2.8e-6 (backbone), <= 6e-8 (head outputs);
- ``run`` end to end: every array of both .npy files to 2e-4 of its own
  largest entry plus 1e-4 (measured <= 3.9e-7 of it), the OBJ's vertices to
  2e-4 (measured 3.8e-6, on coordinates up to ~30), and the overlay on all
  pixels but those where either render's hit mask has an edge (a winner may
  flip between the two rasterizers' float32 edge functions there), to 1
  gray level.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from followmyhold_tpu.hand import hamer as JHH
from followmyhold_tpu.models import hamer as JMH
from followmyhold_tpu.models import mano as JM
from followmyhold_tpu.models import vit as JV
from followmyhold_tpu.ops import camera as JC
from followmyhold_tpu.ops import image as JI
from followmyhold_tpu.ops import rotations as JR
from followmyhold_tpu.utils import mesh_io as JIO
from followmyhold_tpu_torch.hand import hamer as THH
from followmyhold_tpu_torch.models import hamer as TMH
from followmyhold_tpu_torch.models import mano as TM
from followmyhold_tpu_torch.models import vit as TV
from followmyhold_tpu_torch.ops import camera as TC
from followmyhold_tpu_torch.ops import image as TI
from followmyhold_tpu_torch.ops import rotations as TR
from followmyhold_tpu_torch.utils import artifacts as TA
from followmyhold_tpu_torch.utils import mesh_io as TIO
from followmyhold_tpu_torch.utils.params import flax_to_torch

FRAME = 64


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("name,shape", [
    ("rot6d_to_matrix", (5, 6)), ("matrix_to_rot6d", (5, 3, 3)),
    ("axis_angle_to_matrix", (5, 3)), ("matrix_to_axis_angle", (5, 3, 3)),
    ("matrix_to_quaternion", (5, 3, 3)), ("quaternion_to_axis_angle", (5, 4))])
def test_rotations_match_reference(name, shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    if shape[-2:] == (3, 3):   # proper rotations
        x = np.asarray(JR.axis_angle_to_matrix(jnp.asarray(rng.normal(size=(shape[0], 3)))),
                       np.float32)
    if name == "rot6d_to_matrix":
        x[0] = 0.0             # a zero-initialised head: toward the identity, no NaN
    want = np.asarray(getattr(JR, name)(jnp.asarray(x)))
    got = getattr(TR, name)(_t(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_perspective_projection_and_cam_crop_to_full_match_reference():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(2, 21, 3)).astype(np.float32)
    trans = np.array([[0.1, -0.2, 8.0], [0.0, 0.3, 12.0]], np.float32)
    focal = np.array([[600.0, 600.0], [900.0, 850.0]], np.float32)
    center = np.array([[32.0, 30.0], [40.0, 20.0]], np.float32)
    rot = np.asarray(JR.axis_angle_to_matrix(jnp.asarray(rng.normal(size=(2, 3)))), np.float32)
    for kw in ({}, {"camera_center": center}, {"camera_center": center, "rotation": rot}):
        want = JC.perspective_projection(jnp.asarray(pts), jnp.asarray(trans),
                                         jnp.asarray(focal),
                                         **{k: jnp.asarray(v) for k, v in kw.items()})
        got = TC.perspective_projection(_t(pts), _t(trans), _t(focal),
                                        **{k: _t(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)
    cam = np.array([[0.9, 0.05, -0.1], [1.2, -0.3, 0.2]], np.float32)
    size = np.array([50.0, 120.0], np.float32)
    img = np.array([[64.0, 64.0], [200.0, 100.0]], np.float32)
    want = JC.cam_crop_to_full(*(jnp.asarray(a) for a in (cam, center, size, img)), 1250.0)
    got = TC.cam_crop_to_full(*(_t(a) for a in (cam, center, size, img)), 1250.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("do_flip", [False, True], ids=["right", "left"])
def test_generate_patch_image_matches_reference(do_flip):
    """The patch crop of a box reaching past the image (taps outside count
    0), mirrored for a left hand."""
    img = np.random.default_rng(2).uniform(size=(48, 40, 3)).astype(np.float32)
    box = [-6.3, 10.7, 31.5, 31.5]
    with jax.default_matmul_precision("highest"):
        want, want_T = JI.generate_patch_image(jnp.asarray(img), box, (32, 32), do_flip=do_flip)
    got, got_T = TI.generate_patch_image(_t(img), box, (32, 32), do_flip=do_flip)
    np.testing.assert_array_equal(got_T, want_T)
    assert (np.asarray(want) == 0).any() and got.shape == (32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    mask = (img[..., 0] > 0.5).astype(np.float32)   # a single-channel image
    with jax.default_matmul_precision("highest"):
        want_m = JI.warp_affine(jnp.asarray(mask), jnp.asarray(want_T[:2]), (20, 24))
    np.testing.assert_allclose(TI.warp_affine(_t(mask), want_T[:2], (20, 24)).numpy(),
                               np.asarray(want_m), atol=1e-5)


def test_mano_forward_matches_reference():
    rng = np.random.default_rng(3)
    B = 2
    go = np.asarray(JR.axis_angle_to_matrix(jnp.asarray(rng.normal(size=(B, 1, 3)))), np.float32)
    hp = np.asarray(JR.axis_angle_to_matrix(jnp.asarray(0.4 * rng.normal(size=(B, 15, 3)))),
                    np.float32)
    betas = rng.normal(size=(B, 10)).astype(np.float32)
    transl = rng.normal(size=(B, 3)).astype(np.float32)
    jm, tm = JM.synthetic_mano(), TM.synthetic_mano(device="cpu")
    forward = jax.jit(JM.mano_forward)
    with jax.default_matmul_precision("highest"):
        want = forward(jm, jnp.asarray(go), jnp.asarray(hp), jnp.asarray(betas),
                       jnp.asarray(transl))
        want3 = forward(jm, jnp.asarray(go[:, 0]), jnp.asarray(hp), jnp.asarray(betas))
    got = TM.mano_forward(tm, _t(go), _t(hp), _t(betas), _t(transl))
    got3 = TM.mano_forward(tm, _t(go[:, 0]), _t(hp), _t(betas))
    assert got.vertices.shape == (B, 778, 3) and got.joints.shape == (B, 21, 3)
    np.testing.assert_allclose(got.vertices.numpy(), np.asarray(want.vertices), atol=2e-5)
    np.testing.assert_allclose(got.joints.numpy(), np.asarray(want.joints), atol=2e-5)
    np.testing.assert_allclose(got3.vertices.numpy(), np.asarray(want3.vertices), atol=2e-5)
    # the rest pose with zero betas is the template
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (1, 15, 3, 3))
    rest = TM.mano_forward(tm, _t(np.eye(3)[None]), _t(eye), torch.zeros(1, 10))
    np.testing.assert_allclose(rest.vertices[0].numpy(), tm.v_template.numpy(), atol=1e-6)


def _perturbed(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(scale=scale, size=x.shape).astype(np.float32),
        params)


# HaMeR's backbone shape at a tiny width: 256x192, patch 16 with 2 px of padding
# and the cls slot of the position embedding added to every token
_BACKBONE = dict(img_size=(256, 192), patch_size=16, embed_dim=32, depth=1, num_heads=2,
                 patch_padding=2, pos_embed_cls_slot=True)


def test_vit_feature_map_with_patch_padding_and_cls_slot_matches():
    cfg = dict(_BACKBONE, img_size=(64, 48), depth=2)
    jmod = JV.ViTFeatureMap(JV.ViTConfig(dtype=jnp.float32, **cfg))
    x = np.random.default_rng(4).normal(size=(2, 64, 48, 3)).astype(np.float32)
    params = _perturbed(jax.jit(jmod.init)(jax.random.key(0), jnp.zeros((1, 64, 48, 3))), 5)
    tmod = flax_to_torch(params, TV.ViTFeatureMap(TV.ViTConfig(dtype=torch.float32,
                                                               **cfg))).eval()
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jmod.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(_t(x))
    assert got.shape == (2, 4, 3, 32) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def _parity_configs():
    common = dict(head_dim=32, head_depth=1, head_heads=2, head_dim_head=8, head_mlp_dim=32,
                  context_dim=32, image_size=256)
    return (JMH.HamerConfig(backbone=JV.ViTConfig(dtype=jnp.float32, **_BACKBONE),
                            dtype=jnp.float32, **common),
            TMH.HamerConfig(backbone=TV.ViTConfig(dtype=torch.float32, **_BACKBONE),
                            dtype=torch.float32, **common))


@functools.lru_cache(maxsize=None)
def _bridged_hamer(seed=0):
    """The JAX Hamer (parity config) with perturbed weights and its readout
    scaled by 0.01 (the port's random-weight readout gain: the hand stays
    near the mean pose, in front of the camera), and the port's with the
    same weights. Built once (jitted init): no test changes them."""
    jcfg, tcfg = _parity_configs()
    jmodel = JMH.Hamer(jcfg)
    params = _perturbed(jax.jit(jmodel.init)(jax.random.key(seed), jnp.zeros((1, 256, 256, 3))),
                        seed)
    for name in ("decpose", "decshape", "deccam"):
        params["params"]["mano_head"][name]["kernel"] *= 0.01
    tmodel = flax_to_torch(params, TMH.Hamer(tcfg)).eval().requires_grad_(False)
    return jmodel, params, tmodel


def test_hamer_forward_matches_reference():
    jmodel, params, tmodel = _bridged_hamer()
    images = np.random.default_rng(6).normal(size=(2, 256, 256, 3)).astype(np.float32)
    mano = JM.synthetic_mano()
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, x: JMH.hamer_forward(jmodel, p, mano, x))(
            params, jnp.asarray(images))
    with torch.no_grad():
        got = TMH.hamer_forward(tmodel, TM.synthetic_mano(device="cpu"), _t(images))
    for name in TMH.HamerOutput._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=2e-4 * max(1.0, np.abs(w).max()), err_msg=name)
    assert np.abs(np.asarray(want.pred_cam)[:, 0] - 0.9).max() < 0.5


def _write_crop(root, image_id, is_right, seed):
    """A FRAME^2 HOI crop and its hand mask (a 40x36 box off centre)."""
    rng = np.random.default_rng(seed)
    img_dir, mask_dir = os.path.join(root, "crops"), os.path.join(root, "masks")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    img = rng.integers(0, 256, (FRAME, FRAME, 3)).astype(np.uint8)
    Image.fromarray(img).save(os.path.join(img_dir, f"{image_id}_cropped_hoi_{int(is_right)}.png"))
    mask = np.zeros((FRAME, FRAME), np.uint8)
    mask[14:54, 20:56] = 255
    Image.fromarray(mask).save(os.path.join(mask_dir, f"{image_id}_cropped_hand_mask.png"))
    return img_dir, mask_dir


def _edges(hit):
    e = np.zeros_like(hit)
    e[1:] |= hit[1:] != hit[:-1]
    e[:-1] |= hit[1:] != hit[:-1]
    e[:, 1:] |= hit[:, 1:] != hit[:, :-1]
    e[:, :-1] |= hit[:, 1:] != hit[:, :-1]
    return e


@pytest.mark.parametrize("is_right", [True, False], ids=["right", "left"])
def test_run_matches_reference_end_to_end(tmp_path, monkeypatch, is_right):
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    jmodel, params, tmodel = _bridged_hamer()
    monkeypatch.setattr(JHH, "_build_model", lambda cfg: (jmodel, params))
    monkeypatch.setattr(JHH, "_default_config", lambda: jmodel.cfg)
    # the reference's forward, jitted (the same function; eager it takes ~7 s here)
    mano = JM.synthetic_mano()
    forward = jax.jit(lambda p, x: JMH.hamer_forward(jmodel, p, mano, x))
    monkeypatch.setattr(JHH, "hamer_forward", lambda model, p, mano_model, x: forward(p, x))
    img_dir, mask_dir = _write_crop(str(tmp_path), "000003", is_right, 7)
    out = {"jax": str(tmp_path / "jax"), "torch": str(tmp_path / "torch")}
    with jax.default_matmul_precision("highest"):
        JHH.run(img_dir, out["jax"], mask_dir=mask_dir, save_overlay=True)
    THH.run(img_dir, out["torch"], mask_dir=mask_dir, save_overlay=True, model=tmodel,
            device="cpu")
    assert sorted(os.listdir(out["torch"])) == sorted(os.listdir(out["jax"])) == [
        "000003.npy", "000003_hamer.obj", "000003_kps_for_guidance.npy", "000003_overlay.png",
        "J_regressor_hamer.npy"]
    for name in ("000003.npy", "000003_kps_for_guidance.npy"):
        want = np.load(os.path.join(out["jax"], name), allow_pickle=True).item()
        got = np.load(os.path.join(out["torch"], name), allow_pickle=True).item()
        assert sorted(got) == sorted(want), name
        for key in want:
            w, g = np.asarray(want[key]), np.asarray(got[key])
            assert g.shape == w.shape, (name, key)
            np.testing.assert_allclose(g, w, atol=2e-4 * np.abs(w).max() + 1e-4,
                                       err_msg=f"{name} {key}")
    res = np.load(os.path.join(out["torch"], "000003.npy"), allow_pickle=True).item()
    assert res["right"][0] == float(is_right) and res["pred_cam_t_full"][0, 2] > 0
    jobj = JIO.load_mesh(os.path.join(out["jax"], "000003_hamer.obj"))
    tobj = TIO.load_mesh(os.path.join(out["torch"], "000003_hamer.obj"))
    np.testing.assert_array_equal(tobj.faces, jobj.faces)
    np.testing.assert_allclose(tobj.vertices, jobj.vertices, atol=2e-4)
    np.testing.assert_array_equal(
        np.load(os.path.join(out["torch"], "J_regressor_hamer.npy")),
        np.load(os.path.join(out["jax"], "J_regressor_hamer.npy")))

    frame = np.asarray(Image.open(os.path.join(img_dir, os.listdir(img_dir)[0])))
    over = {k: np.asarray(Image.open(os.path.join(v, "000003_overlay.png"))).astype(int)
            for k, v in out.items()}
    hit = {k: (v != frame).any(-1) for k, v in over.items()}
    assert hit["torch"].sum() >= 20, hit["torch"].sum()
    keep = ~(_edges(hit["torch"]) | _edges(hit["jax"]))
    assert np.abs(over["torch"] - over["jax"])[keep].max() <= 1


def test_run_under_the_tiny_profile_writes_every_file_and_skips_done(tmp_path, monkeypatch,
                                                                    capsys):
    """The port's own tiny profile (a 64-px crop cut to the backbone's 48
    columns), seeded random weights, no mask directory (the whole frame)."""
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    img_dir, _ = _write_crop(str(tmp_path), "000004", False, 8)
    out = str(tmp_path / "out")
    THH.run(img_dir, out, save_overlay=True, device="cpu")
    res = np.load(os.path.join(out, "000004.npy"), allow_pickle=True).item()
    kps = np.load(os.path.join(out, "000004_kps_for_guidance.npy"), allow_pickle=True).item()
    assert res["pred_vertices"].shape == (1, 778, 3) and np.isfinite(res["pred_vertices"]).all()
    np.testing.assert_array_equal(res["box_center"][0], [31.5, 31.5])
    assert kps["mano_2d_kps"].shape == (21, 2) and kps["cam_t"].shape == (1, 3)
    assert os.path.exists(os.path.join(out, "000004_overlay.png"))
    THH.run(img_dir, out, device="cpu")
    assert "000004 exists, skipping" in capsys.readouterr().out


def test_multi_hand_raises(tmp_path, monkeypatch, capsys):
    """``multi_hand=True`` no longer raises (the ViTPose and GroundingDINO
    front ends are ported): without a ViTPose file it takes the mask's box,
    as the reference does, and says so once."""
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path / "assets"))
    img_dir, mask_dir = _write_crop(str(tmp_path), "000006", True, 10)
    out = str(tmp_path / "out")
    THH.run(img_dir, out, mask_dir=mask_dir, multi_hand=True, device="cpu")
    assert capsys.readouterr().out.count("no ViTPose file") == 1
    res = np.load(os.path.join(out, "000006.npy"), allow_pickle=True).item()
    assert res["pred_vertices"].shape == (1, 778, 3)
    np.testing.assert_array_equal(res["box_center"][0], [37.5, 33.5])


def test_hand_box_nms_and_names_match_reference(tmp_path):
    rng = np.random.default_rng(9)
    boxes = np.concatenate([rng.uniform(0, 40, (12, 2)), rng.uniform(45, 90, (12, 2))],
                           1).astype(np.float32)
    scores = rng.uniform(size=12)
    np.testing.assert_array_equal(THH.nms_boxes(boxes, scores, 0.3),
                                  JHH.nms_boxes(boxes, scores, 0.3))
    mask = np.zeros((30, 40), np.uint8)
    mask[5:9, 11:30] = 255
    path = str(tmp_path / "m.png")
    Image.fromarray(mask).save(path)
    for p in (path, str(tmp_path / "absent.png"), None):
        np.testing.assert_array_equal(THH._hand_bbox_from_mask(p, (30, 40)),
                                      JHH._hand_bbox_from_mask(p, (30, 40)))
    for name in ("/a/000012_cropped_hoi_1.png", "000013_cropped_hoi_0.jpg", "x_y"):
        assert TA.parse_cropped_hoi_name(name) == JHH.parse_cropped_hoi_name(name)
    assert TA.should_skip(path) and not TA.should_skip(path, str(tmp_path / "absent.png"))
