"""The MoGe stage of the PyTorch port (stage 4: ``ops/image_mesh``, the
linear and nearest resizes, DINOv2's position-embedding resize at MoGe's
grids, ``models/moge`` and ``geometry/moge.run``) against the JAX package,
on the same numpy inputs and, through ``flax_to_torch``, the same weights.

The models are the reference's tiny configuration (a 2-block encoder of
width 32, three neck levels), with the JAX init jitted and its weights
perturbed. Random weights give a point map that is no perspective map: its
focal fit has a flat cost, whose minimum the float32 rounding of the two
libraries' sums places apart (a 0.23 degree field-of-view difference,
measured). So where the focal fit runs, both packages' head outputs are
blended, alike, with ``tools._scene.moge_scene``'s scene: an object in front
of a tilted background at 60 degrees, its z shifted by 1.5, a strip of
invalid pixels, plus 1e-3 of the raw outputs (the GPU smoke run shapes them
the same way). The raw forward is compared unblended.

Tolerances, float32 on both sides (measured on the CPU with these seeds):
- ``depth_edge`` and ``image_mesh``: bit for bit;
- the nearest resize: exactly (the same source indices); the linear resize:
  1e-5 of the largest input (the same weights up to their last bit, summed in
  another order; measured <= 2.0e-7 of it, where the reference itself is
  2.3e-6 off a float64 sum at 512 -> 840);
- the position-embedding resize: 1e-5 (measured 4.8e-7);
- ``ConvStack`` and the forward: 1e-4 of each output's largest entry
  (GroupNorm statistics and convolutions summed in another order; the
  forward measured <= 1.2e-5 of it);
- the focal fit: 1e-4 relative (measured <= 4.5e-6); ``moge_infer``: points,
  depth, normals and intrinsics to 1e-4 of their largest entry (measured
  <= 1.2e-5), the field of view to 1e-4 relative (measured 1.0e-5), the mask
  exactly;
- ``run``: the same files, fov.json equal, depth.npy and points.npy as
  ``moge_infer``, the mask and the mesh's faces exactly, its vertices to 1e-4
  of their largest.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from followmyhold_tpu.geometry import moge as JGM
from followmyhold_tpu.models import moge as JMG
from followmyhold_tpu.models import vit as JV
from followmyhold_tpu.ops import image_mesh as JIM
from followmyhold_tpu.utils import mesh_io as JIO
from followmyhold_tpu_torch.configs import profiles as TPROF
from followmyhold_tpu_torch.geometry import moge as TGM
from followmyhold_tpu_torch.models import moge as TMG
from followmyhold_tpu_torch.models import vit as TV
from followmyhold_tpu_torch.ops import image as TI
from followmyhold_tpu_torch.ops import image_mesh as TIM
from followmyhold_tpu_torch.tools._scene import moge_scene
from followmyhold_tpu_torch.utils import mesh_io as TIO
from followmyhold_tpu_torch.utils.params import flax_to_torch

# the share of the raw head outputs kept beside the scene
NOISE = 1e-3


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _perturbed(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(scale=scale, size=x.shape).astype(np.float32),
        params)


# ---- the host mesh ops, bit for bit --------------------------------------- #

@pytest.mark.parametrize("masked", [True, False], ids=["masked", "full"])
def test_depth_edge_and_image_mesh_are_bit_equal(masked):
    rng = np.random.default_rng(0)
    depth = (2.0 + 0.05 * rng.normal(size=(23, 31))).astype(np.float32)
    depth[5:15, 8:20] = 1.2                          # a step: an edge around it
    points = rng.normal(size=(23, 31, 3)).astype(np.float32)
    attrs = rng.normal(size=(23, 31, 2)).astype(np.float32)
    edge_t, edge_j = TIM.depth_edge(depth, rtol=0.04), JIM.depth_edge(depth, rtol=0.04)
    np.testing.assert_array_equal(edge_t, edge_j)
    assert 0 < edge_t.sum() < edge_t.size
    mask = (rng.uniform(size=(23, 31)) > 0.1) & ~edge_t if masked else None
    got, want = TIM.image_mesh(points, mask, attrs), JIM.image_mesh(points, mask, attrs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(got[1]) > 50


# ---- the resizes ---------------------------------------------------------- #

@pytest.mark.parametrize("src,dst", [((1, 40, 40, 3), (70, 70)), ((1, 96, 96, 3), (51, 51)),
                                     ((2, 48, 64, 2), (35, 47))],
                         ids=["up", "down", "4:3"])
def test_linear_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(1).normal(size=src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (src[0], *dst, src[3]), "linear"))
    got = TI.resize_linear(_t(x), *dst).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(x).max())


@pytest.mark.parametrize("src,dst", [((1, 512, 512, 3), (1, 64, 64, 3)),
                                     ((48, 64, 2), (64, 64, 2)), ((2, 30, 40), (2, 64, 64))],
                         ids=["512_to_64", "4:3", "up"])
def test_nearest_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(2).normal(size=src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, "nearest"))
    got = TI.resize_nearest(_t(x), dst).numpy()
    np.testing.assert_array_equal(got, want)
    if len(src) == 4:   # torch's "nearest-exact", not "nearest"
        nchw = _t(x).permute(0, 3, 1, 2)
        exact = F.interpolate(nchw, size=dst[1:3], mode="nearest-exact").permute(0, 2, 3, 1)
        plain = F.interpolate(nchw, size=dst[1:3], mode="nearest").permute(0, 2, 3, 1)
        np.testing.assert_array_equal(exact.numpy(), want)
        assert not np.array_equal(plain.numpy(), want)


@pytest.mark.parametrize("dst", [(60, 60), (51, 69)], ids=["square", "4:3"])
def test_pos_embed_resize_at_moge_grids_matches(dst):
    """DINOv2-L's 37x37 position embeddings at MoGe's grids (a 512^2 crop and
    a 4:3 one at resolution level 9), with DINOv2's offset of 0.1."""
    pos = np.random.default_rng(3).normal(size=(1, 37 * 37, 8)).astype(np.float32)
    want = JV.interpolate_pos_embed(jnp.asarray(pos), (37, 37), dst, 0.1)
    got = TV.interpolate_pos_embed(_t(pos), (37, 37), dst, 0.1)
    assert got.shape == (1, dst[0] * dst[1], 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    plain = TV.interpolate_pos_embed(_t(pos), (37, 37), dst, 0.0)
    assert np.abs(plain.numpy() - np.asarray(want)).max() > 1e-3   # the offset matters


# ---- the modules ---------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["pixel_shuffle", "bilinear", "nearest"])
def test_conv_stack_matches(kind):
    """Three levels (16, 8, 8 wide), one residual block each, 1x1 output
    convs, inputs at the first two levels."""
    rng = np.random.default_rng(4)
    inputs = [rng.normal(size=(2, 6, 5, 12)).astype(np.float32),
              rng.normal(size=(2, 12, 10, 2)).astype(np.float32)]
    jstack = JMG.ConvStack((16, 8, 8), 3, 1, jnp.float32, resampler=kind)
    params = _perturbed(jax.jit(jstack.init)(jax.random.key(0), [jnp.asarray(x) for x in inputs]),
                        5)
    tstack = flax_to_torch(params, TMG.ConvStack((12, 2), (16, 8, 8), 3, 1, torch.float32,
                                                 resampler=kind)).eval()
    with jax.default_matmul_precision("highest"):
        want = jstack.apply(params, [jnp.asarray(x) for x in inputs])
    with torch.no_grad():
        got = tstack([_t(x).permute(0, 3, 1, 2) for x in inputs])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())


# the reference's tiny profile (followmyhold_tpu/geometry/moge.py:36-42)
_TINY = dict(intermediate_layers=(0, 1), dim_proj=16, neck_dims=(16, 16, 8),
             head_dims=(16, 16, 8), num_res_blocks=1, scale_head_dims=(16, 1),
             num_tokens_range=(4, 16))
_TINY_VIT = dict(img_size=(28, 28), patch_size=14, embed_dim=32, depth=2, num_heads=2,
                 use_cls_token=True, layerscale_init=1e-5)


@functools.lru_cache(maxsize=None)
def _bridged_moge():
    """The JAX tiny MoGe (jitted init, perturbed weights: the metric scale's
    zero readout too) and the port's with the same weights. Built once: no
    test changes the weights."""
    jmodel = JMG.MoGe(JMG.MoGeConfig(encoder=JV.ViTConfig(dtype=jnp.float32, **_TINY_VIT),
                                     dtype=jnp.float32, **_TINY))
    params = _perturbed(jax.jit(jmodel.init, static_argnums=2)(
        jax.random.key(0), jnp.zeros((1, 70, 70, 3)), 25), 6)
    tcfg = TMG.MoGeConfig(encoder=TV.ViTConfig(dtype=torch.float32, **_TINY_VIT),
                          dtype=torch.float32, **_TINY)
    return jmodel, params, flax_to_torch(params, TMG.MoGe(tcfg)).eval().requires_grad_(False)


def test_tiny_profile_and_default_configs_match_reference(monkeypatch):
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    jcfg, tcfg = JGM._default_config(), TPROF.moge_config()
    for name in ("intermediate_layers", "dim_proj", "neck_dims", "head_dims", "num_res_blocks",
                 "resampler", "res_block_hidden_mult", "scale_head_dims", "use_normal_head",
                 "remap_output", "num_tokens_range"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert {k: getattr(tcfg, k) for k in _TINY} == _TINY
    assert {k: getattr(tcfg.encoder, k) for k in _TINY_VIT} == _TINY_VIT
    assert tcfg.dtype == tcfg.encoder.dtype == torch.float32
    monkeypatch.setenv("FOHO_TPU_PROFILE", "full")
    jcfg, tcfg = JGM._default_config(), TPROF.moge_config()
    assert tcfg.neck_dims == jcfg.neck_dims and tcfg.head_dims == jcfg.head_dims
    for name in ("img_size", "patch_size", "embed_dim", "depth", "num_heads", "use_cls_token",
                 "layerscale_init", "pos_interp_offset"):
        assert getattr(tcfg.encoder, name) == getattr(jcfg.encoder, name), name
    # resolution level 9: 3,600 tokens; a 512^2 crop takes a 60x60 grid (3,601
    # tokens with the cls token, K1 at [1,16,3601,64]), a 4:3 one 51x69
    assert TMG.base_grid(3600, 512, 512) == (60, 60)
    assert TMG.base_grid(3600, 384, 512) == (51, 69)
    assert tcfg.encoder.embed_dim // tcfg.encoder.num_heads == 64


def test_moge_forward_matches():
    jmodel, params, tmodel = _bridged_moge()
    img = np.random.default_rng(7).uniform(size=(1, 48, 64, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jmodel.apply, static_argnums=2)(params, jnp.asarray(img), 16)
    with torch.no_grad():
        got = tmodel(_t(img), 16)
    for name in ("points", "mask", "normal", "metric_scale"):
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), err_msg=name)
    assert abs(float(want["metric_scale"][0]) - 1.0) > 1e-3      # the scale head is exercised


def _scene_samples(seed):
    """64^2 nearest samples of the scene's point map, its mask and the view
    plane's UV, with 1e-3 of noise on the points."""
    pts, mask = moge_scene(96, 128)
    pts = pts + 1e-3 * np.random.default_rng(seed).normal(size=pts.shape).astype(np.float32)
    uv = TMG.normalized_view_plane_uv(96, 128).numpy()
    pick = lambda a: TI.resize_nearest(_t(a), (64, 64, *a.shape[2:])).numpy()  # noqa: E731
    return pick(uv).reshape(-1, 2), pick(pts).reshape(-1, 3), pick(mask).reshape(-1) > 0.5


@pytest.mark.parametrize("known", [False, True], ids=["closed_form", "known_focal"])
def test_solve_focal_shift_matches(known):
    uv, pts, mask = _scene_samples(8)
    focal = 1.1 if known else None
    want_f, want_s = JMG.solve_focal_shift(jnp.asarray(uv), jnp.asarray(pts), jnp.asarray(mask),
                                           None if focal is None else jnp.asarray(focal))
    got_f, got_s = TMG.solve_focal_shift(_t(uv), _t(pts)[None], torch.from_numpy(mask)[None],
                                         None if focal is None else torch.tensor([focal]))
    np.testing.assert_allclose(got_f.numpy(), [float(want_f)], rtol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), [float(want_s)], rtol=1e-4)
    if not known:   # the scene's own shift and 60-degree focal are found
        true_focal = (4 / 3) / (1 + (4 / 3) ** 2) ** 0.5 / np.tan(np.radians(30.0))
        assert abs(float(got_s[0]) - 1.5) < 1e-2 and abs(float(got_f[0]) - true_focal) < 1e-2


class _ShapedJaxMoGe:
    """The JAX MoGe's apply, jitted, with the scene blended into its points
    and mask as ``_shape_torch`` blends it into the port's."""

    def __init__(self, model):
        self.cfg = model.cfg
        self._apply = jax.jit(model.apply, static_argnums=2)

    def apply(self, params, image, num_tokens):
        out = dict(self._apply(params, image, num_tokens))
        pts, mask = moge_scene(image.shape[1], image.shape[2])
        out["points"] = jnp.asarray(pts)[None] + NOISE * out["points"]
        out["mask"] = jnp.asarray(mask)[None] + NOISE * (out["mask"] - 0.5)
        return out


def _shape_torch(module, args, out):
    image = args[0]
    pts, mask = moge_scene(image.shape[1], image.shape[2])
    return dict(out, points=torch.from_numpy(pts)[None] + NOISE * out["points"],
                mask=torch.from_numpy(mask)[None] + NOISE * (out["mask"] - 0.5))


@pytest.fixture
def shaped():
    jmodel, params, tmodel = _bridged_moge()
    handle = tmodel.register_forward_hook(_shape_torch)
    try:
        yield _ShapedJaxMoGe(jmodel), params, tmodel
    finally:
        handle.remove()


@pytest.mark.parametrize("fov", [None, 55.0], ids=["unknown_fov", "known_fov"])
def test_moge_infer_matches(shaped, fov):
    jshim, params, tmodel = shaped
    img = np.random.default_rng(9).uniform(size=(1, 48, 64, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = JMG.moge_infer(jshim, params, jnp.asarray(img), fov_x_deg=fov)
    got = TMG.moge_infer(tmodel, _t(img), fov_x_deg=fov)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert 0.5 < got.mask.numpy().mean() < 0.95
    for name in ("points", "depth", "normal", "intrinsics", "metric_scale"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), err_msg=name)
    for name in ("fov_x_deg", "fov_y_deg"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-4, err_msg=name)
    if fov is None:
        assert abs(float(got.fov_x_deg[0]) - 60.0) < 0.5
    else:
        assert abs(float(got.fov_x_deg[0]) - fov) < 1e-3


def _write_crops(folder):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(10)
    for name, hw in (("000001_cropped_hoi_0.png", (48, 48)), ("000002_cropped_hoi_1.png",
                                                             (48, 64))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3)).astype(np.uint8)).save(
            os.path.join(folder, name))


def test_run_matches_reference_end_to_end(shaped, tmp_path, monkeypatch):
    jshim, params, tmodel = shaped
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    monkeypatch.setattr(JGM, "_build_model", lambda cfg: (jshim, params))
    crops = str(tmp_path / "crops")
    _write_crops(crops)
    out = {"jax": str(tmp_path / "jax"), "torch": str(tmp_path / "torch")}
    with jax.default_matmul_precision("highest"):
        JGM.run(crops, out["jax"])
    TGM.run(crops, out["torch"], models=tmodel, device="cpu")
    assert sorted(os.listdir(out["torch"])) == sorted(os.listdir(out["jax"])) == [
        "000001_cropped_hoi", "000002_cropped_hoi"]
    for stem in ("000001_cropped_hoi", "000002_cropped_hoi"):
        j, t = os.path.join(out["jax"], stem), os.path.join(out["torch"], stem)
        assert sorted(os.listdir(t)) == sorted(os.listdir(j))
        with open(os.path.join(j, "fov.json")) as fj, open(os.path.join(t, "fov.json")) as ft:
            assert json.load(ft) == json.load(fj)
        for name in ("depth.npy", "points.npy"):
            w, g = np.load(os.path.join(j, name)), np.load(os.path.join(t, name))
            np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), err_msg=name)
        for name in ("mask.png", "normal.png"):
            w = np.asarray(Image.open(os.path.join(j, name))).astype(int)
            g = np.asarray(Image.open(os.path.join(t, name))).astype(int)
            assert np.abs(g - w).max() <= (0 if name == "mask.png" else 1), name
        jm, tm = JIO.load_mesh(os.path.join(j, "mesh.ply")), TIO.load_mesh(os.path.join(t,
                                                                                    "mesh.ply"))
        assert tm.num_faces == jm.num_faces > 0
        np.testing.assert_array_equal(tm.faces, jm.faces)
        np.testing.assert_allclose(tm.vertices, jm.vertices,
                                   atol=1e-4 * np.abs(jm.vertices).max())
        assert (tm.vertices[:, 2] < 0).all()                  # GL convention: in front is -z
        cloud = TIO.load_mesh(os.path.join(t, "pointcloud.ply"))
        assert cloud.num_faces == 0 and cloud.num_vertices == tm.num_vertices
        # the object's step in depth is a depth edge: the mesh keeps fewer
        # pixels than the mask
        assert tm.num_vertices < (np.asarray(Image.open(os.path.join(t, "mask.png"))) > 0).sum()


def test_run_skips_done_images_and_needs_an_existing_device(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    crops = str(tmp_path / "crops")
    _write_crops(crops)
    TGM.run(crops, str(tmp_path / "out"), device="cpu")      # seeded random weights
    printed = capsys.readouterr().out
    assert printed.count("Processed") == 2
    with open(tmp_path / "out" / "000002_cropped_hoi" / "fov.json") as f:
        fov = json.load(f)
    assert set(fov) == {"fov_x", "fov_y"} and all(np.isfinite(list(fov.values())))
    TGM.run(crops, str(tmp_path / "out"), device="cpu")
    assert "000001_cropped_hoi exists, skipping" in capsys.readouterr().out
    model = TGM._build_model(TPROF.moge_config(), seed=3, device="cpu")
    out = model(torch.rand(1, 28, 28, 3), 4)
    assert torch.equal(out["metric_scale"], torch.ones(1))   # the zero readout: exp(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TGM.run(crops, str(tmp_path / "card"))
