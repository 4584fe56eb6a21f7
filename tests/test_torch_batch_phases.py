"""The batched guidance phases of the PyTorch port: several images in one pass
over a leading image axis (``GuidedSampler._hand_phase_batch``,
``_obj_phase_batch``, ``_joint_phase_batch``) and the layers under them.

- The plain rasterizer, the two-level in-loop decode and marching tets on two
  images at once against each image alone. In every pair one image overflows
  a capacity (the raster tile's faces, the decode's cells, the mesh's vertices
  and faces) and the other does not, so the padding and the truncation are
  shown to stay within their image. The rasterizer and marching tets are held
  bit for bit, values and gradients: each image's work is the same arithmetic
  in the same order. The decode's geo query runs its matrix products at
  another batch size, which a BLAS may sum in another order: 1e-6 (measured
  0 on one CPU).
- The port's batched hand and object phases against the JAX package's
  ``_jitted_batch_phases`` (its vmapped phases) on the same weights, inputs
  and targets, each image with its own field of view, with the JAX batched
  test's tolerances (test_torch_guidance_batch: 5e-2 relative plus 1e-2, and
  each image's optimized hand translation nearer the JAX image with its own
  field of view than a third of its distance to the other's). The object
  phase takes the two-level decode. The JAX renders at 64^2 go through its
  XLA path (not a multiple of its 128^2 kernel tile), which averages exact
  depth ties where the port takes the first face.
- The port's batched joint phase against its calls on one image at a time, at
  1e-3 (its sums at batch 1 and 2 may round apart; measured 0 on one CPU).
- A batch's per-image gathers, fixed-point sums (``ops/losses.image_means``)
  and elementwise 3x3 products at batch 2 against batch 1, bit for bit, and
  against one image's plain formulas at 1e-5.
- ``parse_mesh_shape`` over no devices, and a fill that comes out 0.

The models are test_torch_guidance_batch.py's (its ``models`` fixture); the
phase inputs are _torch_phase_models' (a state that decodes to a surface at the
8^3 grid). The module runs on one torch thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_phase_models import N_SCHED, STEP_I, _phase_inputs
from followmyhold_tpu.configs.guidance import OptimizationConfig as JConfig
from followmyhold_tpu.diffusion import guidance as JG
from followmyhold_tpu.ops.camera import GuidanceCamera as JCamera
from followmyhold_tpu_torch.configs.guidance import OptimizationConfig
from followmyhold_tpu_torch.diffusion import guidance as TG
from followmyhold_tpu_torch.models import hunyuan as TH
from followmyhold_tpu_torch.ops import rasterizer as TR
from followmyhold_tpu_torch.ops import surface as TS
from followmyhold_tpu_torch.ops.camera import GuidanceCamera
from followmyhold_tpu_torch.parallel import mesh as tmesh
from test_torch_guidance_batch import (  # noqa: F401  (models: the module's fixture)
    CAPS,
    FOVS,
    SIZE,
    _np,
    _one_torch_thread,
    models,
)

B = len(FOVS)
# two optimizer steps a phase; the object phase through the two-level decode
PHASE_CONFIG = dict(num_inference_steps=N_SCHED, optimization_steps_hand=2,
                    optimization_steps_scale=2, optimization_steps_joint=2, octree_resolution=8)
PHASE_CAPS = dict(CAPS, inloop_coarse_factor=2)


def _inputs():
    """Two images' states (_phase_inputs of two seeds): poses, noise, latents."""
    xs = [_phase_inputs(seed) for seed in (11, 12)]
    return dict(hand=[np.stack(p) for p in zip(*(x["hand"] for x in xs))],
                obj=[np.stack(p) for p in zip(*(x["obj"] for x in xs))],
                noise=np.stack([x["noise"] for x in xs]),         # [B,1,L,E]
                latents=np.stack([x["latents"] for x in xs]))


def _tpose(p):
    return TG.PoseParams(*(torch.from_numpy(x) for x in p))


def _port_sampler(m, **caps):
    return TG.GuidedSampler(dit=m["tdit"], vae=m["tvae"], camera=GuidanceCamera(SIZE, SIZE, 60.0),
                            config=OptimizationConfig(**PHASE_CONFIG), **dict(PHASE_CAPS, **caps))


def _port_targets(m):
    sampler = _port_sampler(m)
    return TG.stack_targets(m["ttargets"], sampler.camera)


# --------------------------------------------------------------------------- #
# the rasterizer: two images in one pass against each alone
# --------------------------------------------------------------------------- #

def _triangles(n_tri, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.6, 0.6, (n_tri, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(-4.0, -2.0, n_tri)
    offs = rng.uniform(-0.3, 0.3, (n_tri, 3, 3)).astype(np.float32)
    offs[:, :, 2] *= 0.1
    verts = (centers[:, None, :] + offs).reshape(-1, 3)
    normals = rng.normal(size=verts.shape).astype(np.float32)
    return torch.from_numpy(verts), torch.from_numpy(normals / 3.0)


N_TRI, CAP = 60, 12


@pytest.fixture(scope="module")
def raster_images():
    """Two images of 60 face slots: all drawn in the first, 8 in the second
    (the rest masked out), at 50 and 70 degrees, so that only the first
    overflows a tile's 12 faces."""
    meshes = [_triangles(N_TRI, seed) for seed in (1, 2)]
    faces = torch.arange(3 * N_TRI).reshape(-1, 3)
    masks = torch.ones(B, N_TRI)
    masks[1, 8:] = 0.0
    return dict(verts=torch.stack([v for v, _ in meshes]),
                normals=torch.stack([n for _, n in meshes]), faces=faces, masks=masks,
                fov=torch.tensor([50.0, 70.0]), camera=GuidanceCamera(64, 64, 60.0))


def _tiles_plain(packed, gen_seed=3):
    """The plain version's outputs and d(sum of weighted outputs)/d(geom)."""
    geom = packed.geom.clone().requires_grad_(True)
    out = TR.raster_tiles_plain(geom, packed.tile_start, packed.meta)
    g = torch.Generator().manual_seed(gen_seed)
    weights = [torch.randn(out[0].shape, generator=g) for _ in range(3)]
    loss = sum((x * w).sum() for x, w in zip((out[0], out[1], out[3]), weights))
    (dgeom,) = torch.autograd.grad(loss, geom)
    return [x.detach() for x in out], dgeom, weights


def test_plain_rasterizer_batch_equals_each_image_alone(raster_images):
    r = raster_images
    both = TR.bin_and_pack(r["camera"], r["verts"], r["faces"], r["masks"], 0.7, CAP,
                           fov_deg=r["fov"])
    T = both.meta.tiles_per_image
    assert both.tile_start.numel() == B * T + 1 and both.bin_max[0] > CAP >= both.bin_max[1]
    out_b, dgeom_b, weights = _tiles_plain(both)
    for b in range(B):
        one = TR.bin_and_pack(r["camera"], r["verts"][b], r["faces"], r["masks"][b], 0.7, CAP,
                              fov_deg=r["fov"][b])
        assert one.bin_max == both.bin_max[b]
        lo, hi = int(both.tile_start[b * T]), int(both.tile_start[(b + 1) * T])
        assert torch.equal(both.geom[:, lo:hi], one.geom)
        assert torch.equal(both.face_list[lo:hi] - b * N_TRI, one.face_list)
        # the same per-pixel weights as the batch's rows of this image
        geom = one.geom.clone().requires_grad_(True)
        out = TR.raster_tiles_plain(geom, one.tile_start, one.meta)
        loss = sum((x * w[b * T:(b + 1) * T]).sum()
                   for x, w in zip((out[0], out[1], out[3]), weights))
        (dgeom,) = torch.autograd.grad(loss, geom)
        for got, want in zip(out_b, out):
            assert torch.equal(got[b * T:(b + 1) * T], want.detach())
        assert torch.equal(dgeom_b[:, lo:hi], dgeom)


def test_render_batch_equals_each_image_alone(raster_images):
    """render_normal_and_disparity on both images: maps, ids and the
    gradients to vertices and normals, per image."""
    r = raster_images

    def render(verts, normals, masks, fov):
        v, n = verts.clone().requires_grad_(True), normals.clone().requires_grad_(True)
        n01, d01, out = TR.render_normal_and_disparity(
            r["camera"], v, r["faces"], n, masks, faces_per_tile=CAP, fov_deg=fov, device="cpu")
        loss = (n01 ** 2).sum() + (d01 * 2.0).sum() + (out.alpha * 3.0).sum()
        return [n01, d01, out.alpha, out.zbuf, out.face_id, *torch.autograd.grad(loss, (v, n))
                ], out.bin_max

    got, bins = render(r["verts"], r["normals"], r["masks"], r["fov"])
    assert bins[0] > CAP >= bins[1]
    for b in range(B):
        want, bins_b = render(r["verts"][b], r["normals"][b], r["masks"][b], r["fov"][b])
        assert bins_b == bins[b]
        for x, y in zip(got, want):
            assert torch.equal(x[b], y)
    assert (got[4][1] < 8).all() and (got[4][0] >= 8).any()   # each image's own face ids


# --------------------------------------------------------------------------- #
# the in-loop decode and marching tets: two images at once against each alone
# --------------------------------------------------------------------------- #

RES = 8


@pytest.fixture(scope="module")
def decoded(models):
    """Both images' x1 (step_final of _phase_inputs) and each one's cell count
    with room for every cell."""
    x = _inputs()
    sched = _port_sampler(models)._schedule(N_SCHED)
    x1 = TG.step_final(sched, STEP_I, torch.from_numpy(x["noise"][:, 0]),
                       torch.from_numpy(x["latents"][:, 0]))
    _, counts = TH.vae_query_logits_hier_grid_batch(models["tvae"], x1, [-1.1] * 3, [1.1] * 3,
                                                    RES, chunk=128, cell_cap=64)
    return dict(x1=x1, counts=counts)


def _decode(vae, x1, cap, weights):
    lat = x1.clone().requires_grad_(True)
    dense, ind = TH.vae_query_logits_hier_grid_batch(vae, lat, [-1.1] * 3, [1.1] * 3, RES,
                                                     chunk=128, cell_cap=cap)
    (grad,) = torch.autograd.grad((dense * weights).sum(), lat)
    return dense.detach(), ind, grad


def test_batched_decode_equals_each_image_alone(models, decoded):
    counts = decoded["counts"]
    assert counts[0] != counts[1] and 0 < min(counts) and max(counts) < 64
    cap = (counts[0] + counts[1]) // 2           # one image overflows its cells, one does not
    x1 = decoded["x1"]
    w = torch.from_numpy(np.random.default_rng(4).normal(
        size=(B, (RES + 1) ** 3)).astype(np.float32))
    dense, ind, grad = _decode(models["tvae"], x1, cap, w)
    assert sorted(i > cap for i in ind) == [False, True]
    for b in range(B):
        d1, i1, g1 = _decode(models["tvae"], x1[b:b + 1], cap, w[b:b + 1])
        assert ind[b] == i1[0]
        np.testing.assert_allclose(dense[b].numpy(), d1[0].numpy(), rtol=0, atol=1e-6)
        scale = np.abs(g1.numpy()).max()
        np.testing.assert_allclose(grad[b].numpy(), g1[0].numpy(), rtol=0, atol=1e-6 * scale)


def test_batched_marching_tets_equals_each_image_alone(models, decoded):
    sdf = -TH.vae_query_logits_hier_grid_batch(models["tvae"], decoded["x1"], [-1.1] * 3,
                                               [1.1] * 3, RES, chunk=128, cell_cap=64)[0]
    full = [TS.marching_tets(sdf[b], [-1.1] * 3, [1.1] * 3, RES) for b in range(B)]
    nv, nf = [m.num_verts for m in full], [m.num_faces for m in full]
    assert nv[0] != nv[1] and nf[0] != nf[1]
    caps = dict(max_verts=(nv[0] + nv[1]) // 2, max_faces=(nf[0] + nf[1]) // 2)

    def extract(grid):
        grid = grid.detach().clone().requires_grad_(True)
        mesh = TS.marching_tets(grid, [-1.1] * 3, [1.1] * 3, RES, **caps)
        vn = TS.vertex_normals(mesh)
        edges, emask = TS.mesh_edges(mesh.faces, mesh.face_mask)
        n_v = mesh.verts.shape[-2]     # the same weights for every image
        w = torch.sin(torch.arange(n_v * 3, dtype=torch.float32)).reshape(n_v, 3)
        loss = (mesh.verts * w).sum() + (vn[..., 1] ** 2).sum()
        return [*mesh, vn, edges, emask, *torch.autograd.grad(loss, grid)]

    got = extract(sdf)
    # one image filled both buffers, the other neither
    assert sorted(n >= caps["max_verts"] for n in got[2].sum(dim=1).tolist()) == [False, True]
    assert sorted(n >= caps["max_faces"] for n in got[3].sum(dim=1).tolist()) == [False, True]
    for b in range(B):
        for x, y in zip(got, extract(sdf[b])):
            assert torch.equal(x[b], y)


# --------------------------------------------------------------------------- #
# the batched phases against the JAX package's vmapped phases
# --------------------------------------------------------------------------- #

def _jax_stacked_targets(m):
    tg = JG.GuidanceTargets(**{k: jnp.asarray(v) for k, v in m["tg"].items()})
    per_image = [tg._replace(fov_deg=jnp.asarray(f, jnp.float32)) for f in FOVS]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_image)


@pytest.fixture(scope="module")
def jax_phase_runs(models):
    m, x = models, _inputs()
    jsampler = JG.GuidedSampler(dit=m["jdit"], vae=m["jvae"], camera=JCamera(SIZE, SIZE, 60.0),
                                config=JConfig(**PHASE_CONFIG), **PHASE_CAPS)
    hand_phase, obj_phase, _, _, _ = JG._jitted_batch_phases(jsampler)
    targets = _jax_stacked_targets(m)
    jpose = lambda p: JG.PoseParams(*(jnp.asarray(a) for a in p))  # noqa: E731
    with jax.default_matmul_precision("highest"):
        jhand = hand_phase(jpose(x["hand"]), targets)
        jobj = obj_phase(jpose(x["obj"]), jnp.asarray(x["noise"]), jnp.asarray(x["latents"]),
                         m["vae_params"], targets, jsampler._schedule(N_SCHED), STEP_I)
    sampler = _port_sampler(m)
    ttargets = _port_targets(m)
    thand = sampler._hand_phase_batch(_tpose(x["hand"]), ttargets)
    tobj = sampler._obj_phase_batch(_tpose(x["obj"]), torch.from_numpy(x["noise"][:, 0]),
                                    torch.from_numpy(x["latents"][:, 0]), ttargets,
                                    sampler._schedule(N_SCHED), STEP_I)
    return dict(jhand=_np(jhand), jobj=_np(jobj), thand=thand, tobj=tobj, x=x)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=5e-2, atol=1e-2,
                               err_msg=what)


def test_batched_hand_phase_matches_reference(jax_phase_runs):
    (jh, jl, _), (th, tl, trend) = jax_phase_runs["jhand"], jax_phase_runs["thand"]
    assert tl.shape == (B, 2) and torch.isfinite(tl).all()
    # measured: losses 2.2e-7 relative, the pose within 9.8e-5 (quat); each image's
    # translation 3.0e-7 from its own JAX image, 7.4e-4 from the other
    _close(tl.numpy(), jl, "hand losses")
    for name in ("scale", "trans", "quat"):
        _close(getattr(th, name).numpy(), getattr(jh, name), f"hand.{name}")
    for b in range(B):
        own = np.linalg.norm(th.trans[b].numpy() - jh.trans[b])
        other = np.linalg.norm(th.trans[b].numpy() - jh.trans[1 - b])
        assert other > 3.0 * own, (b, own, other)
    assert [len(r["raster_bins"]) for r in trend] == [2, 2]


def test_batched_object_phase_matches_reference(jax_phase_runs):
    (jo, jn, jl, jrend), (to, tn, tl, trend) = jax_phase_runs["jobj"], jax_phase_runs["tobj"]
    assert tl.shape == (B, 2) and torch.isfinite(tl).all()
    # measured: losses 5.2e-7 relative, the pose within 1.7e-5, the noise 6.0e-7 of
    # a 2.0e-4 move
    _close(tl.numpy(), jl, "object losses")
    for name in ("scale", "trans", "quat"):
        _close(getattr(to, name).numpy(), getattr(jo, name), f"obj.{name}")
    _close(tn.numpy(), jn[:, 0], "noise")
    # each image's capacity indicators are its own
    for b in range(B):
        assert trend[b]["hier_cells"] == [int(c) for c in jrend["hier_cells"][b]]
    assert np.abs(tn.numpy() - jax_phase_runs["x"]["noise"][:, 0]).max() > 1e-5   # it moved


# --------------------------------------------------------------------------- #
# the batched joint phase against the port's own calls on one image
# --------------------------------------------------------------------------- #

def test_batched_joint_phase_matches_each_image_alone(models):
    x, sampler = _inputs(), _port_sampler(models)
    sched = sampler._schedule(N_SCHED)
    noise, lat = torch.from_numpy(x["noise"][:, 0]), torch.from_numpy(x["latents"][:, 0])
    hand, obj, tn, tl, trend = sampler._joint_phase_batch(
        _tpose(x["hand"]), _tpose(x["obj"]), noise, lat, _port_targets(models), sched, STEP_I,
        near_end=False)
    assert tl.shape == (B, 2) and torch.isfinite(tl).all()
    for b in range(B):
        h1, o1, n1, l1, r1 = sampler._joint_phase(
            TG.PoseParams(*(torch.from_numpy(a[b]) for a in x["hand"])),
            TG.PoseParams(*(torch.from_numpy(a[b]) for a in x["obj"])), noise[b:b + 1],
            lat[b:b + 1], models["ttargets"][b], sched, STEP_I, near_end=False)
        for got, want in ((hand, h1), (obj, o1)):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g[b].numpy(), w.numpy(), atol=1e-3)
        np.testing.assert_allclose(tn[b].numpy(), n1[0].numpy(), atol=1e-3)
        np.testing.assert_allclose(tl[b].numpy(), l1.numpy(), rtol=1e-3)
        assert trend[b] == r1


def test_batched_intersection_count_is_each_images(models):
    """The near-end count over the batch with masks: each image's own hand,
    posed object and SDF grid (a small sample grid keeps it quick)."""
    x, sampler = _inputs(), _port_sampler(models)
    targets = _port_targets(models)
    sched = sampler._schedule(N_SCHED)
    xyz, bbox = sampler._grid(RES, torch.device("cpu"))
    with torch.no_grad():
        mesh, sdf, _ = sampler._decode(torch.from_numpy(x["noise"][:, 0]),
                                       torch.from_numpy(x["latents"][:, 0]), sched, STEP_I,
                                       xyz, bbox)
        # the hand moved onto the object so that the two overlap
        hand = TG._transform_hand(targets, _tpose(x["hand"]))
        obj_pose = _tpose(x["obj"])
        posed = TG._transform_object(mesh, targets, obj_pose).verts
        hand = hand - hand.mean(dim=1, keepdim=True) + posed[:, :1]
        got = TG._intersection_count(hand, targets.mano_faces, mesh, posed, sdf, bbox, RES,
                                     targets, obj_pose, sample_res=12)
        for b in range(B):
            one = TG._intersection_count(
                hand[b], targets.mano_faces[b], TS.PaddedMesh(*(a[b] for a in mesh)), posed[b],
                sdf[b], bbox, RES, models["ttargets"][b],
                TG.PoseParams(*(a[b] for a in obj_pose)), sample_res=12)
            assert got[b].item() == one.item()
    assert got.shape == (B,) and (got > 0).any()


def test_capacity_warnings_name_the_image(models, capsys):
    """A raster cap between the two images' densest tiles (their fields of
    view differ): only the image beyond it is warned about."""
    x, sampler = _inputs(), _port_sampler(models)
    targets = _port_targets(models)
    one_step = dataclasses.replace(sampler, config=dataclasses.replace(
        sampler.config, optimization_steps_hand=1))
    _, _, renders = one_step._hand_phase_batch(_tpose(x["hand"]), targets)
    bins = [r["raster_bins"][0] for r in renders]
    assert bins[0] != bins[1]
    capped = dataclasses.replace(one_step, hand_faces_per_tile=min(bins))
    _, _, renders = capped._hand_phase_batch(_tpose(x["hand"]), targets)
    capped._warn_capacity_batch("hand", renders)
    over = int(np.argmax(bins))
    out = capsys.readouterr().out
    assert f"hand (batched), image {over}:" in out and f"image {1 - over}:" not in out


# --------------------------------------------------------------------------- #
# a batch's gathers, fixed-point sums and elementwise products
# --------------------------------------------------------------------------- #

def _values_and_grads(fn, inputs, batched=True):
    """fn's outputs and the gradients of their weighted sum, the weights the
    same for each image (outputs lead with the image axis where ``batched``)."""
    xs = [x.clone().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    loss = 0.0
    for o in outs:
        shape = o.shape[1:] if batched else o.shape
        loss = loss + (o.float() * torch.linspace(0.5, 1.5, shape.numel()).reshape(shape)).sum()
    return [o.detach() for o in outs] + list(torch.autograd.grad(loss, xs))


def test_batched_forms_match_the_plain_formulas():
    """What a batch computes (per-image values gathered onto points, sums
    through scatter_rows_add, elementwise 3x3 products; ops/indexing): each
    image's values and gradients equal its own at batch 1 bit for bit, and
    one image's plain formulas (matrix products, torch's sums) to float32
    rounding: 1e-5 of each tensor's largest entry."""
    from followmyhold_tpu_torch.models import mano as TM
    from followmyhold_tpu_torch.ops import losses as TL
    from followmyhold_tpu_torch.ops import transforms as TT

    rng = np.random.default_rng(9)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    verts, quat, trans, scale = t(B, 778, 3), t(B, 4), t(B, 3), t(B).abs() + 0.5
    mask = torch.from_numpy(rng.uniform(size=(B, 778)) > 0.2).float()
    pixels = mask[:, :256].reshape(B, 16, 16)

    def losses(a, b, i):
        # i: a slice of images (a batch, reduced by image_means) or one image,
        # a and b without the image axis (torch's sums of its batch of one)
        one = isinstance(i, int)
        if one:
            a, b = a[None], b[None]
        m = pixels[i:i + 1] if one else pixels[i]
        means = (TL.normal_alignment_loss(a, b, m), TL.masked_l1(a[..., 0], b[..., 0]),
                 TL.mse(a, b))
        if not one:
            return tuple(TL.image_means(*means))
        return tuple(m.values.mean() if m.weights is None else
                     (m.values * m.weights).sum() / m.weights.sum().clamp(min=1.0)
                     for m in means)

    def similarity(v, q, tr, s, i):
        T = TT.rt_from_quat_trans(q, tr)
        if not isinstance(i, int):
            return TT.transform_around_center_w_scale(v, T, s, mask[i])
        c = TT.masked_bbox_center(v, mask[i])
        return (s * (v - c)) @ T[:3, :3].T + c + T[:3, 3]

    def points(v, q, tr, i):
        T = TT.rt_from_quat_trans(q, tr)
        return TT.transform_points(v, T) if not isinstance(i, int) else v @ T[:3, :3].T + T[:3, 3]

    def keypoints(v, j, i):
        if not isinstance(i, int):
            return TM.mano_vert_to_3dkps(v, j)
        kps = torch.cat([j @ v, v[list(TM.FINGERTIP_VERTEX_IDS)]])
        return kps[list(TM.MANO_TO_OPENPOSE)]

    cases = {
        "similarity": ([verts, quat, trans, scale], similarity),
        "transform_points": ([verts, quat, trans], points),
        "keypoints": ([verts, t(B, 16, 778).abs()], keypoints),
        "losses": ([t(B, 16, 16, 3), t(B, 16, 16, 3)], losses),
    }
    for name, (inputs, fn) in cases.items():
        both = _values_and_grads(lambda *xs: fn(*xs, slice(None)), inputs)
        for b in range(B):
            alone = _values_and_grads(lambda *xs: fn(*xs, slice(b, b + 1)),
                                      [x[b:b + 1] for x in inputs])
            plain = _values_and_grads(lambda *xs: fn(*xs, b), [x[b] for x in inputs],
                                      batched=False)
            for i, (x, y, z) in enumerate(zip(both, alone, plain)):
                assert torch.equal(x[b], y[0]), f"{name} output {i}, image {b}"
                scale_ = float(z.abs().max()) or 1.0
                np.testing.assert_allclose(y[0].numpy(), z.numpy(), rtol=0, atol=1e-5 * scale_,
                                           err_msg=f"{name} output {i}, image {b}")


# --------------------------------------------------------------------------- #
# the stage's degenerate faces, judged in the decoded mesh's frame
# --------------------------------------------------------------------------- #

def test_degenerate_faces_are_judged_in_the_decoded_frame():
    """Of an object posed at 1/128 of its decoded size, the stage keeps the
    faces the reference's filter keeps of the decoded mesh (the scale is a
    power of two, so every area scales exactly); the reference's threshold
    applied to the posed mesh drops nearly all of them."""
    from types import SimpleNamespace

    from followmyhold_tpu.geometry import postprocess as JP
    from followmyhold_tpu_torch.geometry import postprocess as TP
    from followmyhold_tpu_torch.guidance import run as TRUN

    res = 24
    ax = np.linspace(-1.1, 1.1, res + 1, dtype=np.float32)
    grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    v, f = TS.marching_tets_host(np.linalg.norm(grid, axis=-1) - 0.8, [-1.1] * 3, [1.1] * 3,
                                 res)
    scale = 2.0 ** -7
    result = SimpleNamespace(obj=TG.PoseParams(torch.tensor([scale]), torch.zeros(3),
                                               torch.tensor([1.0, 0.0, 0.0, 0.0])))
    targets = SimpleNamespace(t_h2m=torch.eye(4))
    assert TRUN._pose_scale(result, targets) == scale
    want_v, want_f = JP.remove_degenerate_faces(v, f)
    got_v, got_f = TP.remove_degenerate_faces(v * np.float32(scale), f,
                                              eps=1e-12 * TRUN._pose_scale(result, targets) ** 4)
    assert len(want_f) > 1000
    assert np.array_equal(got_f, want_f) and np.array_equal(got_v, want_v * np.float32(scale))
    assert len(JP.remove_degenerate_faces(v * np.float32(scale), f)[1]) < len(want_f) // 10


# --------------------------------------------------------------------------- #
# parse_mesh_shape: no devices, a zero fill
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("cards,want", [(0, None), (2, {"dp": 2})], ids=["no_card", "two"])
def test_parse_mesh_shape_default_counts_the_cards(monkeypatch, cards, want):
    """Without a process group the default count is the visible cards'; with
    none it raises, whether or not the spec fills an axis."""
    monkeypatch.setattr(tmesh, "_world_size", lambda: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if want is None:
        for spec in ("dp=-1", "dp=2"):
            with pytest.raises(ValueError, match="no devices to lay a mesh over"):
                tmesh.parse_mesh_shape(spec)
    else:
        assert tmesh.parse_mesh_shape("dp=-1") == want


def test_parse_mesh_shape_refuses_a_zero_fill():
    with pytest.raises(ValueError, match="filled with 0 devices"):
        tmesh.parse_mesh_shape("dp=-1,tp=0", 4)
