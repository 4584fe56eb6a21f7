"""The guidance stage of the PyTorch port (``guidance/run.py`` and what it
reads and writes) against the JAX package, on synthetic artifacts.

- ``build_targets`` on the same files: the MANO mesh in MoGe space, and the
  MoGe mesh's masked normal and disparity renders.
- ``run_hunyuan_w_guid`` end to end under ``FOHO_TPU_PROFILE=tiny``, with the
  JAX package's models bridged into the port and the JAX run's initial noise
  injected (threefry's draws cannot be reproduced): both write the two PLYs,
  and they agree.
- ``run``'s skip-and-continue (outputs present, an empty mask, a failing
  image and a failing export, both reported with their tracebacks); its
  batched runs are tested in test_torch_guidance_batch.
- ``load_mano`` on a synthetic pickle holding a chumpy-like array; the mesh
  IO round trips, read by both packages; ``pad_mesh``'s warning.

Tolerances, float32 on both sides:
- the MANO vertices exactly (the same float32 product); the renders to 1e-4
  on all but 1 % of the masked pixels (edge pixels, where a winner may flip
  between the two rasterizers' float32 edge functions);
- the end-to-end PLYs: the hand vertices to 3e-3 (the reasoning of
  test_torch_guidance: Adam steps of size lr amplify float32 noise; measured
  6.7e-4). The object meshes: face counts within 1 % (a logit near zero may
  change sign between the two runs' float32 sums and add or drop a vertex;
  measured 2,263 faces on both sides), and 99 % of the vertices of either
  mesh within 2e-3 of the other's nearest vertex (measured 5.6e-4, at most
  9.9e-4, on a mesh 1.9 across).
"""

import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from followmyhold_tpu.geometry import hunyuan as JGH
from followmyhold_tpu.guidance import run as JR
from followmyhold_tpu.models import mano as JM
from followmyhold_tpu.ops.camera import GuidanceCamera as JCamera
from followmyhold_tpu.utils import mesh_io as JIO
from followmyhold_tpu.utils.prng import SEED_GUIDANCE, stage_key
from followmyhold_tpu_torch.configs import profiles as TPROF
from followmyhold_tpu_torch.geometry import hunyuan as TGH
from followmyhold_tpu_torch.guidance import run as TR
from followmyhold_tpu_torch.models import hunyuan as TH
from followmyhold_tpu_torch.models import mano as TM
from followmyhold_tpu_torch.ops.camera import GuidanceCamera as TCamera
from followmyhold_tpu_torch.tools._scene import write_stage_inputs
from followmyhold_tpu_torch.utils import mesh_io as TIO
from followmyhold_tpu_torch.utils.params import flax_to_torch
from followmyhold_tpu_torch.utils.prng import stage_generator


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The module on one torch thread: the port's small ops spin a thread
    pool for nothing, and in a six-worker run of the suite that CPU time is
    what the file costs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SIZE = 64
IMAGE = "000001"


def _paths(d, image_id=IMAGE):
    moge = os.path.join(d["moge_out_dir"], f"{image_id}_cropped_hoi")
    return dict(
        cropped_obj_img_path=os.path.join(d["cropped_obj_img_dir"],
                                          f"{image_id}_cropped_inpainted.png"),
        hamer_for_guid_path=os.path.join(d["hamer_out_dir"], f"{image_id}_kps_for_guidance.npy"),
        aligned_mano_mesh_path=os.path.join(d["aligned_mano_dir"],
                                            f"{image_id}_hamer_aligned_mano.ply"),
        cropped_obj_mask_path=os.path.join(d["mask_dir"], f"{image_id}_cropped_obj_mask.png"),
        cropped_hand_mask_path=os.path.join(d["mask_dir"], f"{image_id}_cropped_hand_mask.png"),
        moge_mesh_path=os.path.join(moge, "mesh.ply"),
        T_h2m_path=os.path.join(d["h2m_rt_dir"], f"{image_id}_hoi_mesh.npy"),
        hunyuan_hoi_mesh_path=os.path.join(d["hunyuan_hoi_mesh_dir"], f"{image_id}_hoi_mesh.ply"),
    )


def _dirs_args(d):
    return (d["cropped_obj_img_dir"], d["mask_dir"], d["moge_out_dir"],
            d["hunyuan_hoi_mesh_dir"], d["hamer_out_dir"], d["h2m_rt_dir"],
            d["aligned_mano_dir"], d["guidance_out_dir"])


def test_build_targets_matches_reference(tmp_path):
    # a 24x32 MoGe grid keeps every tile of both rasterizers below its face cap
    d = write_stage_inputs(str(tmp_path), size=SIZE, moge_grid=(24, 32))
    p = _paths(d)
    hand = TR._load_mask(p["cropped_hand_mask_path"])
    obj = TR._load_mask(p["cropped_obj_mask_path"])
    j_reg = np.load(os.path.join(d["hamer_out_dir"], "J_regressor_hamer.npy"))
    args = (p["aligned_mano_mesh_path"], p["T_h2m_path"], p["moge_mesh_path"], hand, obj,
            p["hamer_for_guid_path"], j_reg)
    want = JR.build_targets(JCamera(SIZE, SIZE, 60.0), *args)
    got = TR.build_targets(TCamera(SIZE, SIZE, 60.0), *args, device="cpu")
    for name in ("mano_verts_moge", "mano_faces", "j_regressor", "hamer_2d_kps", "hand_mask",
                 "obj_mask", "t_h2m", "fov_deg"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    hoi = hand | obj
    assert hoi.sum() > 100
    for name in ("moge_normal", "moge_disp"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and np.abs(g).max() > 0.1
        bad = np.abs(g - w) > 1e-4
        bad = bad.any(-1) if bad.ndim == 3 else bad
        assert bad[hoi].mean() <= 0.01, (name, bad[hoi].mean())
        assert not bad[~hoi].any()


def _bridged_models():
    """The JAX package's tiny models (FOHO_TPU_PROFILE=tiny) and the port's,
    with the same weights. The geo query keeps only the lowest Fourier
    frequency, so that the random-weight field is smooth: a noise field's
    surface crosses nearly every cell, overflows every mesh capacity and
    makes the pose gradients noise that Adam amplifies."""
    (jdit, dp), (jvae, vp), (jcond, cp) = JGH.build_models()
    dp, vp, cp = (jax.tree_util.tree_map(np.array, t) for t in (dp, vp, cp))
    kernel = vp["params"]["geo"]["query_in"]["kernel"]
    keep = np.zeros(kernel.shape[0], bool)
    keep[[c * 17 + j for c in range(3) for j in (0, 1, 9)]] = True
    kernel[~keep] = 0.0
    tdit = flax_to_torch(dp, TH.HunyuanDiT(TGH.DIT_PROFILE_TINY))
    tvae = flax_to_torch(vp, TH.ShapeVAE(TH.VAE_TINY))
    tcond = flax_to_torch(cp, TH.Conditioner(TH.COND_TINY))
    tmodels = tuple(m.eval().requires_grad_(False) for m in (tdit, tvae, tcond))
    return ((jdit, dp), (jvae, vp), (jcond, cp)), tmodels


def _raised_raster_cap(module, monkeypatch):
    """The tiny profile's 512 faces a tile would drop faces of the synthetic
    hand (random triangles) in both packages, at other tiles: parity runs
    keep below every cap."""
    caps = dict(module.guidance_mesh_caps(), raster_faces_per_tile=4096)
    monkeypatch.setattr(module, "guidance_mesh_caps", lambda: caps)


def _nearest(a, b):
    """Each row of a's distance to the nearest row of b."""
    return np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1).min(1))


def test_run_hunyuan_w_guid_matches_reference_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    _raised_raster_cap(JR, monkeypatch)
    _raised_raster_cap(TR, monkeypatch)
    d = write_stage_inputs(str(tmp_path / "in"), size=SIZE, moge_grid=(24, 32))
    p = _paths(d)
    j_reg = np.load(os.path.join(d["hamer_out_dir"], "J_regressor_hamer.npy"))
    jmodels, tmodels = _bridged_models()
    cfg_kw = dict(fovx=60.0, j_regressor=j_reg)

    out = {}
    for side in ("jax", "torch"):
        os.makedirs(tmp_path / side)
        save = dict(save_path_obj=str(tmp_path / side / f"{IMAGE}_obj.ply"),
                    save_path_hand=str(tmp_path / side / f"{IMAGE}_hand.ply"))
        monkeypatch.setenv("FOHO_DEBUG_DIR", str(tmp_path / side / "debug"))
        if side == "jax":
            with jax.default_matmul_precision("highest"):
                JR.run_hunyuan_w_guid(**p, **save, **cfg_kw,
                                      config=JR.optimization_config(), models=jmodels)
        else:
            vae_cfg = TH.VAE_TINY
            noise = jax.random.normal(stage_key(SEED_GUIDANCE, "guidance", IMAGE),
                                      (1, vae_cfg.num_latents, vae_cfg.embed_dim), jnp.float32)
            TR.run_hunyuan_w_guid(**p, **save, **cfg_kw, config=TPROF.optimization_config(),
                                  models=tmodels, initial_noise=torch.from_numpy(np.asarray(noise)),
                                  device="cpu")
        out[side] = (JIO.load_mesh(save["save_path_obj"]), JIO.load_mesh(save["save_path_hand"]))

    (jobj, jhand), (tobj, thand) = out["jax"], out["torch"]
    assert thand.num_vertices == 778 and np.array_equal(thand.faces, jhand.faces)
    np.testing.assert_allclose(thand.vertices, jhand.vertices, atol=3e-3)
    assert tobj.num_faces > 500 and abs(tobj.num_faces - jobj.num_faces) <= 0.01 * jobj.num_faces
    near = np.concatenate([_nearest(tobj.vertices, jobj.vertices),
                           _nearest(jobj.vertices, tobj.vertices)])
    assert np.quantile(near, 0.99) <= 2e-3
    # the debug directory: the parameters and the loss lines of every phase
    dbg = tmp_path / "torch" / "debug" / f"exp_obj{IMAGE}_inpainted"
    lines = (dbg / "losses.txt").read_text().splitlines()
    assert (dbg / "params.json").exists() and any(x.startswith("hand final") for x in lines)
    assert any(x.startswith("joint_5 final") for x in lines)
    assert (dbg / "hand_normal_grid.npy").exists() and (dbg / "step05_disp.npy").exists()


def _stage(tmp_path, **kw):
    d = write_stage_inputs(str(tmp_path), size=SIZE, moge_grid=(24, 32), **kw)
    return d


def test_run_skips_done_and_empty_mask_images(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    d = _stage(tmp_path / "a", image_id="000001")
    write_stage_inputs(str(tmp_path / "a"), image_id="000002", size=SIZE, moge_grid=(24, 32))
    Image.fromarray(np.zeros((SIZE, SIZE), np.uint8)).save(
        os.path.join(d["mask_dir"], "000002_cropped_hand_mask.png"))
    for name in ("000001_obj.ply", "000001_hand.ply"):
        (tmp_path / "a" / "guidance_out_dir" / name).write_bytes(b"")
    TR.run(str(tmp_path), *_dirs_args(d), device="cpu")
    printed = capsys.readouterr().out
    assert "000001 already exists, skipping" in printed
    assert "Skipping 000002 due to empty mask" in printed
    assert "Finished processing all images" in printed
    assert sorted(os.listdir(d["guidance_out_dir"])) == ["000001_hand.ply", "000001_obj.ply"]


def test_run_reports_failures_with_their_tracebacks(tmp_path, monkeypatch, capsys):
    """An image that fails before its export (no fov.json) and one whose
    export fails in the pool: both are reported with a traceback, and the run
    goes on (the reference drops the export's traceback)."""
    monkeypatch.setenv("FOHO_TPU_PROFILE", "tiny")
    d = _stage(tmp_path, image_id="000001")
    write_stage_inputs(str(tmp_path), image_id="000002", size=SIZE, moge_grid=(24, 32))
    os.remove(os.path.join(d["moge_out_dir"], "000002_cropped_hoi", "fov.json"))

    def broken_export(*args, **kwargs):
        raise ValueError("export broke")

    monkeypatch.setattr(TR, "_export_and_write", broken_export)
    monkeypatch.setattr(TR.GuidedSampler, "run", lambda self, *a, **k: None)
    TR.run(str(tmp_path), *_dirs_args(d), device="cpu")
    captured = capsys.readouterr()
    printed = captured.out + captured.err
    assert "Error in processing 000001 : export broke" in printed
    assert "Error in processing 000002_cropped_inpainted.png" in printed
    assert printed.count("Traceback (most recent call last)") == 2
    assert 'raise ValueError("export broke")' in printed
    assert "Finished processing all images" in printed


def test_load_mano_reads_a_pickle_with_chumpy_arrays(tmp_path, monkeypatch):
    """A pickle in the official layout whose v_template is a chumpy array
    (pickled while a stand-in chumpy module existed), read by both packages
    without chumpy."""
    rng = np.random.default_rng(0)
    chumpy = types.ModuleType("chumpy")
    ch = types.ModuleType("chumpy.ch")

    class Ch:
        pass

    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    ch.Ch = Ch
    monkeypatch.setitem(sys.modules, "chumpy", chumpy)
    monkeypatch.setitem(sys.modules, "chumpy.ch", ch)
    v_template = Ch()
    v_template.x = rng.normal(size=(778, 3))
    data = {"v_template": v_template,
            "shapedirs": rng.normal(size=(778, 3, 10)),
            "posedirs": rng.normal(size=(778, 3, 135)),
            "J_regressor": rng.uniform(size=(16, 778)),
            "weights": rng.uniform(size=(778, 16)),
            "f": rng.integers(0, 778, (1538, 3)).astype(np.uint32)}
    path = tmp_path / "MANO_RIGHT.pkl"
    path.write_bytes(pickle.dumps(data, protocol=2))
    monkeypatch.delitem(sys.modules, "chumpy.ch")
    monkeypatch.delitem(sys.modules, "chumpy")

    got = TM.load_mano(str(path), device="cpu")
    want = JM.load_mano(str(path))
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.posedirs.shape == (135, 778 * 3) and got.faces.dtype == torch.int64
    # no file: the synthetic stand-in, as in the reference
    missing = TM.load_mano(str(tmp_path / "absent.pkl"), device="cpu")
    np.testing.assert_array_equal(missing.faces.numpy(), np.asarray(JM.synthetic_mano().faces))


@pytest.mark.parametrize("fmt", ["ply_binary", "ply_ascii", "obj"])
def test_mesh_io_round_trips_between_packages(tmp_path, fmt):
    rng = np.random.default_rng(1)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    f = rng.integers(0, 50, (80, 3)).astype(np.int32)
    for writer, reader in ((TIO, JIO), (JIO, TIO), (TIO, TIO)):
        path = str(tmp_path / ("m.obj" if fmt == "obj" else "m.ply"))
        if fmt == "obj":
            writer.write_obj(path, v, f)
        else:
            writer.write_ply(path, v, f, binary=fmt == "ply_binary")
        mesh = reader.load_mesh(path)
        np.testing.assert_allclose(mesh.vertices, v, rtol=1e-6)
        np.testing.assert_array_equal(mesh.faces, f)


def test_pad_mesh_matches_reference_and_warns_above_its_caps(capsys):
    mesh = TIO.HostMesh(np.arange(30, dtype=np.float32).reshape(10, 3),
                        np.array([[0, 1, 9], [2, 3, 4], [5, 6, 7]], np.int32))
    got = TIO.pad_mesh(mesh, 6, 2)
    want = JIO.pad_mesh(JIO.HostMesh(mesh.vertices, mesh.faces), 6, 2)
    assert "exceeds the caps" in capsys.readouterr().out
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    TIO.pad_mesh(mesh, 16, 8)
    assert capsys.readouterr().out == ""


def test_stage_generator_is_per_image_and_seeded():
    a = torch.randn(4, generator=stage_generator(2, "guidance", "000001", "cpu"))
    b = torch.randn(4, generator=stage_generator(2, "guidance", "000001", "cpu"))
    c = torch.randn(4, generator=stage_generator(2, "guidance", "000002", "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
