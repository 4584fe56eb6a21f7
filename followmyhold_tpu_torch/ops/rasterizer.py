"""Tiled differentiable rasterizer: hand-written CUDA kernels for Hopper plus
their plain PyTorch version.

Counterpart of followmyhold_tpu/ops/rasterizer.py (its Pallas path). It stands
in for the original pipeline's PyTorch3D renderer stack: interpolated vertex
normals, an order-independent soft silhouette, and zbuf-based disparity.

How a render goes:

1. Faces are projected and binned to 16x16 pixel tiles by their bounding box
   padded with the silhouette's reach (torch ops). A tile's faces are packed
   contiguously in ascending face id: ``face_list[P]`` with ``tile_start[T+1]``.
   ``faces_per_tile`` caps a tile's list; ``RasterOut.bin_max`` reports the true
   worst count so that callers can warn when faces were dropped. A batch of B
   images (verts [B,V,3]) is binned image by image as one image is, and the B
   packed lists join image-major into one list of B*T tiles over the images'
   concatenated faces, so that each kernel runs once for the batch; every
   output then leads with B.
2. ``raster_tiles`` returns, per pixel, the winning slot of the tile's list with
   its barycentrics (w1, w2), and the visibility product of the soft coverage.
   On a CUDA tensor this is the kernel pair csrc/raster_fwd.cu and
   csrc/raster_bwd.cu behind one ``torch.autograd.Function``; on a CPU tensor it
   is ``raster_tiles_plain``, whose gradient is autograd of itself. The kernels
   split each tile's list into chunks of ``RASTER_CHUNK`` slots
   (``raster_chunk_plan``), one block a chunk.
3. Depth and normal interpolation, and their gradients, are gathers on the
   winner ids in torch.

Tie-break: the first face (lowest id) with a strictly smaller depth wins.
Both windings are drawn. The silhouette sigma is in PIXELS. Coverage is
clamped to 1 - 1e-3 so the visibility product's gradient stays finite.

Reach: a face's coverage is 0 at a distance of 2 sigma or more, so a pixel
outside the face's bounding box padded by ``RasterMeta.reach`` (2 sigma + 1
pixel) does not change the face's visibility factor. The kernels skip such
(pixel, face) pairs; the plain version, the yardstick, evaluates every pair.
The two differ only where float rounding puts a far pixel "inside" a sliver
face (all three edge functions within rounding of zero, on the line of a face
seen edge-on): the plain version then counts the pair, the kernels do not.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from followmyhold_tpu_torch.ops import _kernels
from followmyhold_tpu_torch.ops import precision  # noqa: F401  (sets the TF32 policy)
from followmyhold_tpu_torch.ops.camera import FovLike, GuidanceCamera
from followmyhold_tpu_torch.ops.indexing import (
    image_rows,
    repeat_per_image,
    take_image_rows,
    take_rows,
)
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device

TILE_H = 16
TILE_W = 16
_TILE_PIXELS = TILE_H * TILE_W
_COV_CAP = 1.0 - 1e-3   # max per-face coverage: keeps d(prod)/d(cov) finite
_PLAIN_STEP_ELEMS = 1 << 22   # tiles x faces x pixels per step of the plain version
_BIG = 3.0e38
# slots of a tile's list that one block of the kernels takes (csrc/raster_common.cuh
# kChunk; the kernels refuse another value)
RASTER_CHUNK = 64


class RasterOut(NamedTuple):
    """One image's render, or a batch's with every tensor leading with B."""

    zbuf: torch.Tensor     # [H,W] camera-space depth, -1 where no face
    normal: torch.Tensor   # [H,W,3] interpolated vertex normals (unnormalized), 0 where empty
    alpha: torch.Tensor    # [H,W] soft silhouette in [0,1]
    face_id: torch.Tensor  # [H,W] int64 winning face, -1 where empty
    # true (pre-clamp) max faces overlapping one tile (a list, one per image, for
    # a batch): if this exceeds bin_capacity, faces were dropped in the densest
    # tiles (wrong pixels AND wrong gradients there)
    bin_max: Union[int, List[int]] = 0
    bin_capacity: int = 0


class RasterMeta(NamedTuple):
    tiles_x: int
    tiles_per_image: int   # the packed lists hold T / tiles_per_image images in turn
    inv_sigma: float
    znear: float
    zfar: float

    @property
    def reach(self) -> float:
        """Bounding-box padding beyond which a face cannot touch a pixel:
        2 sigma (where the coverage reaches 0) + 1 pixel, as a float32."""
        return float(np.float32(2.0 / self.inv_sigma + 1.0))


# --------------------------------------------------------------------------- #
# binning
# --------------------------------------------------------------------------- #

def _bin_faces(tri: torch.Tensor, valid: torch.Tensor, H: int, W: int,
               faces_per_tile: int, sigma_px: float):
    """Tile/face overlap of B images -> their packed per-tile face lists, joined
    image-major.

    tri [B,F,3,3], valid [B,F]. Returns (face_list [P] int64: the faces of image
    b are numbered b*F + f, ascending within a tile; tile_start [B*T+1] int32;
    bin_max, each image's true worst count as a list). A tile keeps its first
    ``faces_per_tile`` faces, as it would alone.
    """
    dev = tri.device
    B, F = valid.shape
    ty, tx = H // TILE_H, W // TILE_W
    n_tiles = ty * tx
    pad = sigma_px * 3.0 + 1.0
    xy = tri[..., :2].detach()
    fmin = xy.amin(dim=2) - pad                      # [B,F,2]
    fmax = xy.amax(dim=2) + pad

    tile_ids = torch.arange(n_tiles, device=dev)
    tile_y0 = ((tile_ids // tx) * TILE_H)[None, :, None]
    tile_x0 = ((tile_ids % tx) * TILE_W)[None, :, None]
    overlap = (
        (fmin[:, None, :, 0] <= (tile_x0 + TILE_W - 1))
        & (fmax[:, None, :, 0] >= tile_x0)
        & (fmin[:, None, :, 1] <= (tile_y0 + TILE_H - 1))
        & (fmax[:, None, :, 1] >= tile_y0)
        & valid[:, None, :]
    ).reshape(B * n_tiles, F)                        # [B*T,F]
    true_counts = overlap.sum(dim=1)
    pairs = overlap.nonzero()                        # sorted by image and tile, then face
    tile_of = pairs[:, 0]
    first = torch.cumsum(true_counts, 0) - true_counts
    pos = torch.arange(pairs.shape[0], device=dev) - first[tile_of]
    kept = pairs[pos < faces_per_tile]               # one host read sizes it
    face_list = kept[:, 1] + (kept[:, 0] // n_tiles) * F
    counts = true_counts.clamp(max=faces_per_tile)
    tile_start = torch.zeros(B * n_tiles + 1, dtype=torch.int32, device=dev)
    tile_start[1:] = torch.cumsum(counts, 0)
    bin_max = (true_counts.reshape(B, n_tiles).amax(dim=1).tolist() if n_tiles
               else [0] * B)
    return face_list, tile_start, bin_max


def _untile_images(x: torch.Tensor, ty: int, tx: int) -> torch.Tensor:
    """[B*T, TILE_H, TILE_W, ...] -> [B, H, W, ...] (T = ty * tx)."""
    c = x.shape[3:]
    x = x.reshape(-1, ty, tx, TILE_H, TILE_W, *c)
    x = x.permute(0, 1, 3, 2, 4, *range(5, 5 + len(c)))
    return x.reshape(-1, ty * TILE_H, tx * TILE_W, *c)


def _untile(x: torch.Tensor, ty: int, tx: int) -> torch.Tensor:
    """One image's [T, TILE_H, TILE_W, ...] -> [H, W, ...]."""
    if x.shape[0] != ty * tx:
        raise ValueError(f"{x.shape[0]} tiles are not one {ty}x{tx}-tile image")
    return _untile_images(x, ty, tx)[0]


# --------------------------------------------------------------------------- #
# plain version of the two kernels
# --------------------------------------------------------------------------- #

def _seg_dist(ax, ay, bx, by, uu, vv):
    """Unsigned pixel distance to the segment (a, b)."""
    abx = bx - ax
    aby = by - ay
    len2 = (abx * abx + aby * aby).clamp(min=1e-12)
    apx = uu - ax
    apy = vv - ay
    tpar = ((apx * abx + apy * aby) / len2).clamp(0.0, 1.0)
    dx = apx - tpar * abx
    dy = apy - tpar * aby
    return torch.sqrt(dx * dx + dy * dy + 1e-12)


def _plain_chunk(geom, idx, in_list, uu, vv, best_z, best_s, best_w1, best_w2, vis,
                 slot0: int, meta: RasterMeta):
    """One chunk of C slots for every tile: [T,C,1] face scalars against
    [T,1,256] pixels. The operations and their order are the kernel's."""
    g = geom[:, idx][..., None]                      # [9,T,C,1]
    x0, y0, z0, x1, y1, z1, x2, y2, z2 = g.unbind(0)

    def edge(ax, ay, bx, by):
        return (bx - ax) * (vv - ay) - (by - ay) * (uu - ax)

    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    degen = area.abs() < 1e-12
    inv_area = 1.0 / torch.where(degen, torch.ones_like(area), area)
    w0 = edge(x1, y1, x2, y2) * inv_area
    w1 = edge(x2, y2, x0, y0) * inv_area
    w2 = edge(x0, y0, x1, y1) * inv_area
    zpix = w0 * z0 + w1 * z1 + w2 * z2
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)

    dmin = torch.minimum(
        torch.minimum(_seg_dist(x1, y1, x2, y2, uu, vv), _seg_dist(x2, y2, x0, y0, uu, vv)),
        _seg_dist(x0, y0, x1, y1, uu, vv))
    d_signed = torch.where(inside, dmin, -dmin)
    cov = (d_signed * (0.25 * meta.inv_sigma) + 0.5).clamp(0.0, _COV_CAP)

    ok = in_list[..., None] & ~degen                 # [T,C,1]
    hit = inside & ok & (zpix > meta.znear) & (zpix < meta.zfar)
    zc = torch.where(hit, zpix, torch.full_like(zpix, _BIG))
    zmin, arg = zc.min(dim=1)                        # first minimum along the chunk
    pick = arg[:, None]
    take = zmin < best_z
    best_z = torch.where(take, zmin, best_z)
    best_s = torch.where(take, arg + slot0, best_s)
    best_w1 = torch.where(take, w1.gather(1, pick)[:, 0], best_w1)
    best_w2 = torch.where(take, w2.gather(1, pick)[:, 0], best_w2)
    vis = vis * torch.prod(1.0 - torch.where(ok, cov, torch.zeros_like(cov)), dim=1)
    return best_z, best_s, best_w1, best_w2, vis


def raster_tiles_plain(geom: torch.Tensor, tile_start: torch.Tensor, meta: RasterMeta,
                       chunk: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel pair: same function, same tie-break.

    geom [9,P] f32, tile_start [T+1] -> (w1, w2 f32, slot int32, vis f32), each
    [T,16,16]; the T tiles are T / ``meta.tiles_per_image`` images in turn. Its
    gradient is autograd of this forward. It walks the lists ``chunk`` slots at
    a time (by default as many as keep a step's intermediates near 4M elements
    an image) and checkpoints each step, so no [faces, pixels] intermediate
    outlives its step; a step takes only the tiles whose lists reach it. The
    default step depends on one image's tiles only, so each image of a batch
    rounds as it does alone: bit for bit the same.
    """
    dev = geom.device
    T = tile_start.numel() - 1
    P = geom.shape[1]
    starts = tile_start[:-1].long()
    counts = (tile_start[1:] - tile_start[:-1]).long()
    kmax = int(counts.max().item()) if T else 0
    if chunk is None:
        chunk = max(16, _PLAIN_STEP_ELEMS // max(meta.tiles_per_image * _TILE_PIXELS, 1))
    chunk = max(1, min(chunk, kmax))

    tiles = torch.arange(T, device=dev) % meta.tiles_per_image   # within its image
    pix = torch.arange(_TILE_PIXELS, device=dev)
    uu = ((tiles % meta.tiles_x) * TILE_W)[:, None, None] + (pix % TILE_W)[None, None, :]
    vv = ((tiles // meta.tiles_x) * TILE_H)[:, None, None] + (pix // TILE_W)[None, None, :]
    uu, vv = uu.to(geom.dtype), vv.to(geom.dtype)

    best_z = torch.full((T, _TILE_PIXELS), _BIG, dtype=geom.dtype, device=dev)
    best_s = torch.full((T, _TILE_PIXELS), -1, dtype=torch.long, device=dev)
    best_w1 = torch.zeros((T, _TILE_PIXELS), dtype=geom.dtype, device=dev)
    best_w2 = torch.zeros_like(best_w1)
    vis = torch.ones_like(best_w1)
    state = [best_z, best_s, best_w1, best_w2, vis]

    for slot0 in range(0, kmax, chunk):
        # only the tiles with slots left: a finished list would add nothing
        live = (counts > slot0).nonzero().squeeze(1)
        slots = slot0 + torch.arange(chunk, device=dev)
        in_list = slots[None, :] < counts[live, None]                    # [T',C]
        idx = (starts[live, None] + slots[None, :]).clamp(max=max(P - 1, 0))
        new = checkpoint(_plain_chunk, geom, idx, in_list, uu[live], vv[live],
                         *(x[live] for x in state), slot0, meta, use_reentrant=False)
        state = [x.index_copy(0, live, y) for x, y in zip(state, new)]
    best_z, best_s, best_w1, best_w2, vis = state

    shape = (T, TILE_H, TILE_W)
    return (best_w1.reshape(shape), best_w2.reshape(shape),
            best_s.to(torch.int32).reshape(shape), vis.reshape(shape))


# --------------------------------------------------------------------------- #
# the kernels' chunk plan and wrappers
# --------------------------------------------------------------------------- #

def raster_chunk_plan_plain(tile_start: torch.Tensor, n_slots: int):
    """Cut every tile's list into chunks of at most ``RASTER_CHUNK`` consecutive
    slots, on the tensor's device and without reading anything back to the host.

    Tile t gets max(1, ceil(count_t / RASTER_CHUNK)) chunks (an empty tile one, whose
    block writes the tile's empty outputs), numbered ``chunk_start[t]`` to
    ``chunk_start[t+1] - 1``: chunk_start [T+1] int32 is their exclusive
    cumulative sum. Returns (chunk_start, bound), where ``bound = T +
    ceil(n_slots / RASTER_CHUNK)`` >= chunk_start[T] is known on the host and sizes
    the kernels' grid and scratch; blocks past chunk_start[T] exit. A kernel
    block finds its tile by a binary search in chunk_start."""
    T = tile_start.numel() - 1
    counts = tile_start[1:] - tile_start[:-1]
    per_tile = ((counts + (RASTER_CHUNK - 1)) // RASTER_CHUNK).clamp_(min=1)
    chunk_start = torch.zeros(T + 1, dtype=torch.int32, device=tile_start.device)
    torch.cumsum(per_tile, 0, dtype=torch.int32, out=chunk_start[1:])
    return chunk_start, T + math.ceil(n_slots / RASTER_CHUNK)


def raster_chunk_plan(tile_start: torch.Tensor, n_slots: int):
    """``raster_chunk_plan_plain``'s result: on a CUDA tensor one launch of the
    plan kernel (csrc/raster_fwd.cu), which takes the host a fraction of the
    torch ops' time; on a CPU tensor the plain version."""
    if not tile_start.is_cuda:
        return raster_chunk_plan_plain(tile_start, n_slots)
    if tile_start.dtype != torch.int32 or not tile_start.is_contiguous():
        raise ValueError("tile_start must be contiguous int32 [T+1]")
    T = tile_start.numel() - 1
    chunk_start = torch.empty(T + 1, dtype=torch.int32, device=tile_start.device)
    lib = _kernels.load_library()
    with torch.cuda.device(tile_start.device):
        code = lib.fmh_raster_chunk_plan(tile_start.data_ptr(), chunk_start.data_ptr(), T,
                                         RASTER_CHUNK, torch.cuda.current_stream().cuda_stream)
    _kernels.check_launch(code, "raster_chunk_plan")
    _kernels.LAUNCH_COUNTS["raster_chunk_plan"] += 1
    return chunk_start, T + math.ceil(n_slots / RASTER_CHUNK)


def _check_kernel_inputs(geom: torch.Tensor, tile_start: torch.Tensor,
                         meta: RasterMeta) -> None:
    T = tile_start.numel() - 1
    if meta.tiles_per_image < 1 or T % meta.tiles_per_image or \
            meta.tiles_per_image % meta.tiles_x:
        raise ValueError(f"{T} tiles are not whole images of {meta.tiles_per_image} tiles "
                         f"{meta.tiles_x} wide")
    if not geom.is_cuda or tile_start.device != geom.device:
        raise ValueError("rasterizer kernels take CUDA tensors on one device")
    if geom.dtype != torch.float32 or geom.dim() != 2 or geom.shape[0] != 9:
        raise ValueError(f"geom must be float32 [9,P], got {geom.dtype} {tuple(geom.shape)}")
    if tile_start.dtype != torch.int32 or tile_start.dim() != 1 or tile_start.numel() < 2:
        raise ValueError("tile_start must be int32 [T+1]")
    if not (geom.is_contiguous() and tile_start.is_contiguous()):
        raise ValueError("rasterizer kernels take contiguous tensors")


def raster_tiles_forward(geom: torch.Tensor, tile_start: torch.Tensor, meta: RasterMeta,
                         plan=None):
    """Launch the forward kernel: (w1, w2, slot, vis), each [T,16,16].
    ``plan`` is ``raster_chunk_plan(tile_start, P)``, made here if not given."""
    _check_kernel_inputs(geom, tile_start, meta)
    T, P = tile_start.numel() - 1, geom.shape[1]
    if plan is None:
        plan = raster_chunk_plan(tile_start, P)
    chunk_start, bound = plan
    w1 = torch.empty((T, TILE_H, TILE_W), dtype=torch.float32, device=geom.device)
    w2 = torch.empty_like(w1)
    vis = torch.empty_like(w1)
    slot = torch.empty((T, TILE_H, TILE_W), dtype=torch.int32, device=geom.device)
    # per-chunk partial results (z, w1, w2, vis, slot) of the tiles with more
    # than one chunk, merged in chunk order by the entry point's second launch
    scratch = torch.empty((5, bound, _TILE_PIXELS), dtype=torch.float32, device=geom.device)
    lib = _kernels.load_library()
    with torch.cuda.device(geom.device):
        code = lib.fmh_raster_fwd(
            geom.data_ptr(), tile_start.data_ptr(), chunk_start.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), slot.data_ptr(), vis.data_ptr(), scratch.data_ptr(), T, P,
            meta.tiles_x, meta.tiles_per_image, bound, RASTER_CHUNK, 0.25 * meta.inv_sigma,
            meta.reach, meta.znear, meta.zfar, torch.cuda.current_stream().cuda_stream)
    _kernels.check_launch(code, "raster_fwd")
    _kernels.LAUNCH_COUNTS["raster_fwd"] += 1
    return w1, w2, slot, vis


def raster_tiles_backward(geom, tile_start, slot, vis, gw1, gw2, gvis, meta: RasterMeta,
                          plan=None):
    """Launch the backward kernel: dgeom [9,P] (z rows are zero), every column
    written by one warp. ``plan`` as for ``raster_tiles_forward``."""
    _check_kernel_inputs(geom, tile_start, meta)
    T, P = tile_start.numel() - 1, geom.shape[1]
    if plan is None:
        plan = raster_chunk_plan(tile_start, P)
    chunk_start, bound = plan
    grads = [g.contiguous() for g in (gw1, gw2, gvis)]
    for x in (slot, vis, *grads):
        if x.device != geom.device or tuple(x.shape) != (T, TILE_H, TILE_W):
            raise ValueError("per-pixel inputs must be [T,16,16] on geom's device")
    dgeom = torch.empty_like(geom)
    lib = _kernels.load_library()
    with torch.cuda.device(geom.device):
        code = lib.fmh_raster_bwd(
            geom.data_ptr(), tile_start.data_ptr(), chunk_start.data_ptr(), slot.data_ptr(),
            vis.data_ptr(), grads[0].data_ptr(), grads[1].data_ptr(), grads[2].data_ptr(),
            dgeom.data_ptr(), T, P, meta.tiles_x, meta.tiles_per_image, bound, RASTER_CHUNK,
            0.25 * meta.inv_sigma, meta.reach, torch.cuda.current_stream().cuda_stream)
    _kernels.check_launch(code, "raster_bwd")
    _kernels.LAUNCH_COUNTS["raster_bwd"] += 1
    return dgeom


class _RasterTilesCuda(torch.autograd.Function):
    """Forward and backward kernels as one differentiable function of geom."""

    @staticmethod
    def forward(ctx, geom, tile_start, meta):
        plan = raster_chunk_plan(tile_start, geom.shape[1])
        w1, w2, slot, vis = raster_tiles_forward(geom, tile_start, meta, plan)
        ctx.save_for_backward(geom, tile_start, slot, vis, plan[0])
        ctx.meta, ctx.bound = meta, plan[1]
        ctx.mark_non_differentiable(slot)
        return w1, w2, slot, vis

    @staticmethod
    def backward(ctx, gw1, gw2, _gslot, gvis):
        geom, tile_start, slot, vis, chunk_start = ctx.saved_tensors
        dgeom = raster_tiles_backward(geom, tile_start, slot, vis, gw1, gw2, gvis, ctx.meta,
                                      (chunk_start, ctx.bound))
        return dgeom, None, None


def raster_tiles(geom: torch.Tensor, tile_start: torch.Tensor, meta: RasterMeta):
    """Per-tile rasterization: the kernels for a CUDA tensor, the plain version
    for a CPU tensor."""
    if geom.is_cuda:
        return _RasterTilesCuda.apply(geom, tile_start, meta)
    return raster_tiles_plain(geom, tile_start, meta)


# --------------------------------------------------------------------------- #
# rendering
# --------------------------------------------------------------------------- #

class TileInputs(NamedTuple):
    """What the per-tile step takes: of one image, or of a batch of B (tri
    [B,F,3,3], face ids b*F + f in face_list, B*T tiles, bin_max a list)."""

    tri: torch.Tensor         # [F,3,3] screen (u, v, depth) of every face corner
    face_list: torch.Tensor   # [P] face id of every packed (tile, slot)
    geom: torch.Tensor        # [9,P] the packed faces' screen coordinates
    tile_start: torch.Tensor  # [T+1] int32
    meta: RasterMeta
    bin_max: Union[int, List[int]]


def _batched_faces(faces: torch.Tensor, B: int) -> torch.Tensor:
    """Faces shared by the batch ([F,3]) or its own per image ([B,F,3]) -> [B,F,3]."""
    return faces.expand(B, *faces.shape) if faces.dim() == 2 else faces


def bin_and_pack(camera: GuidanceCamera, verts: torch.Tensor, faces: torch.Tensor,
                 face_mask: torch.Tensor, sigma_px: float, faces_per_tile: int,
                 fov_deg: FovLike = None) -> TileInputs:
    """Project, bin and pack: everything the per-tile step takes. A face is
    drawn only if its mask is set and all three corners lie beyond znear.

    One image: verts [V,3], faces [F,3], face_mask [F], ``fov_deg`` a number,
    a 0-d tensor or None. A batch: verts [B,V,3], faces [F,3] or [B,F,3],
    face_mask [B,F], ``fov_deg`` None, a number or [B] (one per image)."""
    H, W = camera.height, camera.width
    if H % TILE_H or W % TILE_W:
        raise ValueError(f"image {H}x{W} is not a multiple of the {TILE_H}x{TILE_W} tile")
    batched = verts.dim() == 3
    if not batched:
        verts, faces, face_mask = verts[None], faces[None], face_mask[None]
    B = verts.shape[0]
    tri = take_image_rows(camera.project(verts, fov_deg=fov_deg),
                      _batched_faces(faces, B))               # [B,F,3,3] (u,v,z)
    valid = (face_mask > 0) & (tri[..., 2] > camera.znear).all(dim=-1)
    face_list, tile_start, bin_max = _bin_faces(tri, valid, H, W, faces_per_tile, sigma_px)
    geom = take_rows(tri.reshape(-1, 9).float(), face_list).t().contiguous()   # [9,P]
    tiles_x = W // TILE_W
    meta = RasterMeta(tiles_x=tiles_x, tiles_per_image=tiles_x * (H // TILE_H),
                      inv_sigma=1.0 / max(sigma_px, 1e-6), znear=float(camera.znear),
                      zfar=float(camera.zfar))
    if not batched:
        return TileInputs(tri[0], face_list, geom, tile_start, meta, bin_max[0])
    return TileInputs(tri, face_list, geom, tile_start, meta, bin_max)


def rasterize(
    camera: GuidanceCamera,
    verts: torch.Tensor,         # [V,3] world (GL convention), or [B,V,3]
    faces: torch.Tensor,         # [F,3] integer, or [B,F,3]
    vert_normals: torch.Tensor,  # [V,3], or [B,V,3]
    face_mask: torch.Tensor,     # [F], or [B,F]
    sigma_px: float = 0.7,
    faces_per_tile: int = 4096,
    fov_deg: FovLike = None,
    force_plain: bool = False,
    device: DeviceLike = "cuda",
) -> RasterOut:
    """Render depth, interpolated normals, soft silhouette and winner ids.

    Given verts [B,V,3], it renders the B images in one pass (one launch of
    each kernel) and every output leads with B; ``fov_deg`` may then hold one
    field of view per image. Each image's render is the one it gets alone.
    ``force_plain`` routes the per-tile step through the plain version even on
    a CUDA tensor; it exists to hold the kernels against it.
    """
    dev = resolve_device(device)
    verts, vert_normals = verts.to(dev), vert_normals.to(dev)
    faces, face_mask = faces.to(dev).long(), face_mask.to(dev)
    batched = verts.dim() == 3
    if not batched:
        verts, faces, vert_normals, face_mask = (
            verts[None], faces[None], vert_normals[None], face_mask[None])
    B = verts.shape[0]
    faces = _batched_faces(faces, B)
    ty, tx = camera.height // TILE_H, camera.width // TILE_W
    tri, face_list, geom, tile_start, meta, bin_max = bin_and_pack(
        camera, verts, faces, face_mask, sigma_px, faces_per_tile, fov_deg)
    F = tri.shape[1]
    tri_n = take_image_rows(vert_normals, faces)                   # [B,F,3,3]
    if force_plain:
        w1, w2, slot, vis = raster_tiles_plain(geom, tile_start, meta)
    else:
        w1, w2, slot, vis = raster_tiles(geom, tile_start, meta)

    mask = slot >= 0
    if face_list.numel():
        # a pixel without a winner gathers its tile's first face (masked out below)
        pos = tile_start[:-1].long()[:, None, None] + slot.clamp(min=0).long()
        fid_safe = face_list[pos.clamp(max=face_list.numel() - 1)]
        corner = take_rows(tri.reshape(B * F, 3, 3), fid_safe)   # [B*T,t,t,3,3]
        nrm = take_rows(tri_n.reshape(B * F, 3, 3), fid_safe)
        w0 = 1.0 - w1 - w2
        z = w0 * corner[..., 0, 2] + w1 * corner[..., 1, 2] + w2 * corner[..., 2, 2]
        normal = (w0[..., None] * nrm[..., 0, :] + w1[..., None] * nrm[..., 1, :]
                  + w2[..., None] * nrm[..., 2, :])
    else:  # nothing binned: no pixel has a winner
        fid_safe = torch.zeros_like(slot, dtype=torch.long)
        z = torch.zeros_like(w1)
        normal = torch.zeros((*w1.shape, 3), dtype=w1.dtype, device=dev)
    # face ids within each image
    image_of = image_rows(slot.shape[0] // meta.tiles_per_image, meta.tiles_per_image,
                          dev)[:, None, None]
    fid = torch.where(mask, fid_safe - image_of * F, torch.full_like(fid_safe, -1))
    zbuf = torch.where(mask, z, torch.full_like(z, -1.0))
    normal = torch.where(mask[..., None], normal, torch.zeros_like(normal))

    # Interior pixels of a closed mesh sit near shared edges where each face's
    # soft coverage is ~0.5; the hard hit-mask (no gradient) saturates them to
    # 1 while the soft product keeps the boundary gradients.
    alpha = torch.maximum(mask.to(vis.dtype), 1.0 - vis)

    out = RasterOut(zbuf=_untile_images(zbuf, ty, tx), normal=_untile_images(normal, ty, tx),
                    face_id=_untile_images(fid, ty, tx), alpha=_untile_images(alpha, ty, tx),
                    bin_max=bin_max, bin_capacity=int(faces_per_tile))
    if batched:
        return out
    return out._replace(zbuf=out.zbuf[0], normal=out.normal[0], face_id=out.face_id[0],
                        alpha=out.alpha[0], bin_max=bin_max[0])


def render_normal_and_disparity(
    camera: GuidanceCamera,
    verts: torch.Tensor,
    faces: torch.Tensor,
    vert_normals: torch.Tensor,
    face_mask: torch.Tensor,
    sigma_px: float = 0.7,
    faces_per_tile: int = 4096,
    fov_deg: FovLike = None,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor, RasterOut]:
    """Normal map in [0,1] + normalized disparity: empty depth -> 10,
    disparity = 1/(z+1e-6), both maps min/max-normalized over the image;
    background normals 0. A batch (verts [B,V,3], see ``rasterize``) is
    normalized image by image, each image's numbers and gradients those it
    gets alone.
    """
    out = rasterize(camera, verts, faces, vert_normals, face_mask, sigma_px=sigma_px,
                    faces_per_tile=faces_per_tile, fov_deg=fov_deg, device=device)
    batched = out.zbuf.dim() == 3
    zbuf = out.zbuf if batched else out.zbuf[None]             # [B,H,W]
    n = out.normal if batched else out.normal[None]            # [B,H,W,3]
    fg = ((out.face_id if batched else out.face_id[None]) >= 0)[..., None]

    # normalize over each image's foreground; the background stays 0
    inf = torch.full_like(n, float("inf"))
    nmin = torch.where(fg, n, inf).amin(dim=(1, 2, 3))
    nmax = torch.where(fg, n, -inf).amax(dim=(1, 2, 3))
    nmin = torch.where(torch.isfinite(nmin), nmin, torch.zeros_like(nmin))
    nmax = torch.where(torch.isfinite(nmax), nmax, torch.ones_like(nmax))
    depth = torch.where(zbuf < 0, torch.full_like(zbuf, 10.0), zbuf)
    disp = 1.0 / (depth + 1e-6)
    # each image's four bounds gathered onto each entry of its normal map, so
    # that their gradients sum over the image's own pixels (ops/indexing)
    g = repeat_per_image(torch.stack([nmin, nmax, disp.amin(dim=(1, 2)), disp.amax(dim=(1, 2))],
                                     dim=1), n[0].numel()).reshape(*n.shape, 4)
    nmin, nmax, dmin, dmax = g.unbind(-1)
    n01 = (n - nmin) / (nmax - nmin + 1e-6)
    n01 = torch.where(fg, n01, torch.zeros_like(n01))
    dmin, dmax = dmin[..., 0], dmax[..., 0]
    disp01 = (disp - dmin) / (dmax - dmin + 1e-6)
    if batched:
        return n01, disp01, out
    return n01[0], disp01[0], out
