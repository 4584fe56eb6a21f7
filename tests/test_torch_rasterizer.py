"""Rasterizer of the PyTorch port against the JAX package.

The plain version that stands beside the CUDA kernels has the Pallas kernel's
semantics (first face with a strictly smaller depth wins), so it is held
against the Pallas path run in interpret mode: values, and gradients to
vertices and normals with the tolerances of the JAX package's own
kernel-vs-XLA test (2e-2 of the largest gradient: gradients are dense sums over
pixels, and pixels on an edge's line are ill-conditioned in float32). It is
also held against the XLA path, which averages exact depth ties.
"""

import functools
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from followmyhold_tpu.ops import rasterizer as JR
from followmyhold_tpu.ops.camera import GuidanceCamera as JCamera
from followmyhold_tpu_torch.ops import _kernels
from followmyhold_tpu_torch.ops import rasterizer as TR
from followmyhold_tpu_torch.ops.camera import GuidanceCamera as TCamera

SIZE = 128
JCAM = JCamera(height=SIZE, width=SIZE, fov_deg=60.0)
TCAM = TCamera(height=SIZE, width=SIZE, fov_deg=60.0)


@contextmanager
def _pallas_interpret_on_cpu():
    orig_call, orig_on_tpu = pl.pallas_call, JR._on_tpu
    pl.pallas_call = functools.partial(orig_call, interpret=True)
    JR._on_tpu = lambda: True
    JR._raster_tiles_pallas.cache_clear()
    try:
        yield
    finally:
        pl.pallas_call, JR._on_tpu = orig_call, orig_on_tpu
        JR._raster_tiles_pallas.cache_clear()


def _irregular_mesh(n_tri=40, seed=5):
    """Random small triangles in front of the camera, no grid alignment."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.8, 0.8, (n_tri, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(-4.0, -2.0, n_tri)
    offs = rng.uniform(-0.25, 0.25, (n_tri, 3, 3)).astype(np.float32)
    offs[:, :, 2] *= 0.1
    verts = (centers[:, None, :] + offs).reshape(-1, 3)
    faces = np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3)
    normals = rng.normal(size=(3 * n_tri, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return verts, faces, normals, np.ones(n_tri, np.float32)


def _torch_args(v, f, n, m):
    return (torch.from_numpy(v), torch.from_numpy(f).long(), torch.from_numpy(n),
            torch.from_numpy(m))


def _jax_pallas(v, f, n, m, **kw):
    with _pallas_interpret_on_cpu():
        return JR.rasterize(JCAM, jnp.asarray(v), jnp.asarray(f), jnp.asarray(n),
                            jnp.asarray(m), faces_per_tile=64, **kw)


def _assert_same_render(out, ref, id_slack):
    """out: torch RasterOut, ref: JAX RasterOut."""
    ref_id, out_id = np.asarray(ref.face_id), out.face_id.numpy()
    assert (ref_id != out_id).mean() <= id_slack
    same = (ref_id == out_id) & (ref_id >= 0)
    assert same.sum() > 0.99 * (ref_id >= 0).sum()
    np.testing.assert_allclose(out.zbuf.detach().numpy()[same], np.asarray(ref.zbuf)[same],
                               atol=1e-4)
    np.testing.assert_allclose(out.normal.detach().numpy()[same],
                               np.asarray(ref.normal)[same], atol=1e-4)
    np.testing.assert_allclose(out.alpha.detach().numpy(), np.asarray(ref.alpha), atol=1e-4)


def test_plain_version_matches_pallas_forward():
    mesh = _irregular_mesh()
    ref = _jax_pallas(*mesh)
    out = TR.rasterize(TCAM, *_torch_args(*mesh), faces_per_tile=64, device="cpu")
    assert out.zbuf.shape == (SIZE, SIZE) and out.normal.shape == (SIZE, SIZE, 3)
    _assert_same_render(out, ref, id_slack=0.0)   # same tie-break: identical winners
    assert _kernels.launch_counts()["raster_fwd"] == 0   # no launch on the CPU


def test_plain_version_matches_xla_forward():
    mesh = _irregular_mesh(seed=9)
    ref = JR.rasterize(JCAM, *(jnp.asarray(a) for a in mesh), faces_per_tile=64,
                       force_xla=True)
    out = TR.rasterize(TCAM, *_torch_args(*mesh), faces_per_tile=64, device="cpu")
    _assert_same_render(out, ref, id_slack=1e-3)  # the XLA path averages exact ties


def _loss_terms():
    tgt_a = np.zeros((SIZE, SIZE), np.float32)
    tgt_a[40:90, 40:90] = 1.0
    tgt_n = np.zeros((SIZE, SIZE, 3), np.float32)
    tgt_n[..., 2] = 0.5
    return tgt_a, tgt_n


def test_plain_version_matches_pallas_gradients():
    v, f, n, m = _irregular_mesh(n_tri=12, seed=7)
    tgt_a, tgt_n = _loss_terms()

    def jloss(verts, normals):
        out = JR.rasterize(JCAM, verts, jnp.asarray(f), normals, jnp.asarray(m),
                           faces_per_tile=64)
        return (jnp.sum((out.alpha - tgt_a) ** 2) + jnp.sum((out.normal - tgt_n) ** 2)
                + jnp.sum(jnp.where(out.face_id >= 0, out.zbuf, 0.0)))

    with _pallas_interpret_on_cpu():
        gv_ref, gn_ref = jax.grad(jloss, (0, 1))(jnp.asarray(v), jnp.asarray(n))

    tv, tf, tn, tm = _torch_args(v, f, n, m)
    tv.requires_grad_(True)
    tn.requires_grad_(True)
    out = TR.rasterize(TCAM, tv, tf, tn, tm, faces_per_tile=64, device="cpu")
    loss = (((out.alpha - torch.from_numpy(tgt_a)) ** 2).sum()
            + ((out.normal - torch.from_numpy(tgt_n)) ** 2).sum()
            + torch.where(out.face_id >= 0, out.zbuf, torch.zeros_like(out.zbuf)).sum())
    loss.backward()

    vscale = float(np.abs(np.asarray(gv_ref)).max()) + 1e-6
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(gv_ref), atol=2e-2 * vscale)
    nscale = float(np.abs(np.asarray(gn_ref)).max()) + 1e-6
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(gn_ref), atol=2e-2 * nscale)
    # and nearly everywhere much closer than that
    close = np.abs(tv.grad.numpy() - np.asarray(gv_ref)) <= 1e-3 * vscale
    assert close.mean() > 0.95


def test_masked_and_near_plane_faces_are_skipped_like_the_reference():
    v, f, n, m = _irregular_mesh(n_tri=20, seed=11)
    m[::3] = 0.0                 # masked faces
    v[3:6, 2] = 0.005            # one face with corners in front of znear
    ref = _jax_pallas(v, f, n, m)
    out = TR.rasterize(TCAM, *_torch_args(v, f, n, m), faces_per_tile=64, device="cpu")
    _assert_same_render(out, ref, id_slack=0.0)
    drawn = set(np.unique(out.face_id.numpy())) - {-1}
    assert drawn and all(i % 3 != 0 and i != 1 for i in drawn)


def test_render_normal_and_disparity_matches():
    mesh = _irregular_mesh(seed=13)
    with _pallas_interpret_on_cpu():
        jn01, jd01, _ = JR.render_normal_and_disparity(
            JCAM, *(jnp.asarray(a) for a in mesh), faces_per_tile=64)
    tn01, td01, out = TR.render_normal_and_disparity(
        TCAM, *_torch_args(*mesh), faces_per_tile=64, device="cpu")
    np.testing.assert_allclose(tn01.numpy(), np.asarray(jn01), atol=1e-4)
    np.testing.assert_allclose(td01.numpy(), np.asarray(jd01), atol=1e-4)
    assert float(tn01.min()) >= 0.0 and float(td01.max()) <= 1.0
    assert out.bin_capacity == 64 and 0 < out.bin_max <= 64


def test_empty_mesh_renders_background():
    v, f, n, m = _irregular_mesh(n_tri=4)
    m[:] = 0.0
    n01, d01, out = TR.render_normal_and_disparity(
        TCAM, *_torch_args(v, f, n, m), faces_per_tile=64, device="cpu")
    with _pallas_interpret_on_cpu():
        jn01, jd01, jout = JR.render_normal_and_disparity(
            JCAM, *(jnp.asarray(a) for a in (v, f, n, m)), faces_per_tile=64)
    assert (out.face_id == -1).all() and float(out.alpha.max()) == 0.0
    assert float(out.zbuf.max()) == -1.0 and out.bin_max == 0
    np.testing.assert_allclose(n01.numpy(), np.asarray(jn01), atol=1e-6)
    np.testing.assert_allclose(d01.numpy(), np.asarray(jd01), atol=1e-6)
    assert torch.isfinite(n01).all() and torch.isfinite(d01).all()


def test_bin_overflow_is_reported():
    mesh = _irregular_mesh(n_tri=40)
    out = TR.rasterize(TCAM, *_torch_args(*mesh), faces_per_tile=2, device="cpu")
    assert out.bin_capacity == 2 and out.bin_max > 2


def test_tile_lists_are_packed_in_ascending_face_order():
    v, f, n, m = _torch_args(*_irregular_mesh())
    packed = TR.bin_and_pack(TCAM, v, f, m, 0.7, 64)
    starts = packed.tile_start.long()
    assert starts[0] == 0 and starts[-1] == packed.face_list.numel()
    assert packed.geom.shape == (9, packed.face_list.numel())
    for t in range(starts.numel() - 1):
        ids = packed.face_list[starts[t]:starts[t + 1]]
        assert (ids[1:] > ids[:-1]).all()


def test_image_must_be_a_multiple_of_the_tile():
    cam = TCamera(height=100, width=128, fov_deg=60.0)
    with pytest.raises(ValueError, match="multiple"):
        TR.rasterize(cam, *_torch_args(*_irregular_mesh(n_tri=2)), device="cpu")


def test_entry_point_needs_an_existing_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.render_normal_and_disparity(TCAM, *_torch_args(*_irregular_mesh(n_tri=2)))


def _chunk_lookup(chunk_start, tile_start, bound):
    """What each block of the kernels finds for itself (csrc/raster_common.cuh
    find_tile), in torch: for every block id below ``bound`` its (tile, first
    slot of the tile's list, number of slots), tile -1 past the last chunk."""
    T, chunk = tile_start.numel() - 1, TR.RASTER_CHUNK
    ids = torch.arange(bound, dtype=torch.int32)
    tile = torch.searchsorted(chunk_start[:T], ids, right=True).to(torch.int32) - 1
    live = ids < chunk_start[T]
    t = tile.clamp(min=0).long()
    first = (ids - chunk_start[t]) * chunk
    count = tile_start[t + 1] - tile_start[t]
    n = torch.clamp(torch.minimum(count - first, torch.full_like(first, chunk)), min=0)
    tile = torch.where(live, tile, torch.full_like(tile, -1))
    return tile, torch.where(live, first, 0), torch.where(live, n, 0)


def _check_plan(tile_start):
    """The kernels' chunk plan covers every slot of every list once, with no
    chunk crossing a tile, gives every tile (an empty one too) a chunk, and
    stays within the host-known bound that sizes the grid."""
    P, chunk = int(tile_start[-1]), TR.RASTER_CHUNK
    chunk_start, bound = TR.raster_chunk_plan(tile_start, P)
    T = tile_start.numel() - 1
    counts = (tile_start[1:] - tile_start[:-1]).long()
    assert chunk_start.dtype == torch.int32 and chunk_start.shape == (T + 1,)
    assert bound == T + -(-P // chunk) and int(chunk_start[-1]) <= bound
    assert (chunk_start[1:] > chunk_start[:-1]).all()          # every tile has a chunk
    tile, first, n = _chunk_lookup(chunk_start, tile_start, bound)
    live = tile >= 0
    assert int(live.sum()) == int(chunk_start[-1]) and not live[int(chunk_start[-1]):].any()
    covered = torch.zeros(P, dtype=torch.long)
    for t, f, m in zip(tile[live].tolist(), first[live].tolist(), n[live].tolist()):
        assert 0 <= m <= chunk and f % chunk == 0
        assert f + m <= counts[t] and (m > 0 or counts[t] == 0)  # inside its own tile
        covered[int(tile_start[t]) + f:int(tile_start[t]) + f + m] += 1
    assert (covered == 1).all()
    return chunk_start


@pytest.mark.parametrize("counts", [[0, 3, 0, 0, 64, 1, 5 * 64 + 3, 0, 128, 65],
                                    [0, 0, 0], [700], [1] * 7],
                         ids=["mixed", "all_empty", "one_long_tile", "short_tiles"])
def test_chunk_plan_covers_every_slot_once(counts):
    tile_start = torch.zeros(len(counts) + 1, dtype=torch.int32)
    tile_start[1:] = torch.cumsum(torch.tensor(counts), 0)
    chunk_start = _check_plan(tile_start)
    per_tile = (chunk_start[1:] - chunk_start[:-1]).tolist()
    assert per_tile == [max(1, -(-c // TR.RASTER_CHUNK)) for c in counts]


def test_chunk_plan_of_a_binned_mesh():
    v, f, n, m = _torch_args(*_irregular_mesh(n_tri=40))
    packed = TR.bin_and_pack(TCAM, v, f, m, 0.7, 64)
    _check_plan(packed.tile_start)


@pytest.mark.parametrize("seed", [3, 4])
def test_pairs_beyond_the_reach_add_nothing(seed):
    """What the kernels' cull rests on: a pixel outside a face's bounding box
    padded by the reach (2 sigma + 1 px) gets coverage exactly 0 from that
    face and is not inside it. The plain version evaluates every pair, and at
    every pixel outside all the faces' padded boxes it leaves vis exactly 1
    and no winner."""
    v, f, n, m = _torch_args(*_irregular_mesh(n_tri=30, seed=seed))
    packed = TR.bin_and_pack(TCAM, v, f, m, 0.7, 64)
    meta = packed.meta
    assert meta.reach == pytest.approx(2 * 0.7 + 1.0) and isinstance(meta.reach, float)
    _, _, slot, vis = TR.raster_tiles_plain(packed.geom, packed.tile_start, meta)
    xy = packed.tri[..., :2].detach()
    lo, hi = xy.amin(dim=1) - meta.reach, xy.amax(dim=1) + meta.reach     # [F,2]
    u = torch.arange(SIZE, dtype=torch.float32)
    in_x = (u[None, :] >= lo[:, :1]) & (u[None, :] <= hi[:, :1])          # [F,W]
    in_y = (u[None, :] >= lo[:, 1:]) & (u[None, :] <= hi[:, 1:])          # [F,H]
    far = ~(in_y[:, :, None] & in_x[:, None, :]).any(dim=0)               # [H,W]
    vis, slot = TR._untile(vis, 8, 8), TR._untile(slot, 8, 8)
    assert far.any() and (~far).any()
    assert (vis[far] == 1.0).all() and (slot[far] == -1).all()
    assert (vis[~far] < 1.0).any() and (slot[~far] >= 0).any()
