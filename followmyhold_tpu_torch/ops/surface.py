"""Differentiable SDF -> mesh extraction into fixed-capacity buffers.

Counterpart of followmyhold_tpu/ops/surface.py: marching tetrahedra over
padded buffers.

- each cube splits into 6 tetrahedra around the main diagonal; each tet emits
  at most 2 triangles, whose vertices lie on sign-changing tet edges,
- vertex positions are linear interpolations  v = p_i + s_i/(s_i - s_j) (p_j - p_i)
  -> differentiable w.r.t. the SDF values,
- vertices are deduplicated through global-edge keys
  (grid-vertex index * 7 + direction code).

The output contract is the reference's: verts in ascending edge-key order,
faces in candidate order (tet, cell, triangle), padded verts repeat verts[0],
padded faces are (0,0,0), masks mark the valid entries, capacities are static.
The reference replaced its table lookups with one-hot matrix products and
shifted-slice channel volumes because small gathers are slow on its hardware;
here the tables are simply gathered.

The 16-case tet table is generated at import time with triangle orientation
fixed against the inside->outside direction.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from followmyhold_tpu_torch.ops.indexing import scatter_rows_add, take_rows
from followmyhold_tpu_torch.ops.safe import safe_normalize

# Cube corners: id = 4*dx + 2*dy + dz  ->  (dx, dy, dz)
_CORNERS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], np.int64
)

# Six tetrahedra around the main diagonal c0 - c7.
_TETS = np.array(
    [[0, 4, 6, 7], [0, 6, 2, 7], [0, 2, 3, 7],
     [0, 3, 1, 7], [0, 1, 5, 7], [0, 5, 4, 7]], np.int64
)

# 7 canonical edge directions (nonneg components): axis edges, face diagonals,
# main diagonal.
_DIRS = np.array(
    [[1, 0, 0], [0, 1, 0], [0, 0, 1],
     [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int64
)


def _build_tet_tables():
    """Per-tet case tables.

    Returns:
      edge_corners: [6(tet), 6(edge), 2] local cube-corner ids per tet edge
      tri_table:    [6(tet), 16(case), 2(tri), 3] edge index in 0..5, -1 = none

    Triangle orientation: normals point from inside (sdf<0) to outside.
    """
    edge_corners = np.full((6, 6, 2), -1, np.int64)
    tri_table = np.full((6, 16, 2, 3), -1, np.int64)
    edge_pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]  # local tet verts

    def edge_idx(i, j):
        return edge_pairs.index((min(i, j), max(i, j)))

    for t, tet in enumerate(_TETS):
        for e, (a, b) in enumerate(edge_pairs):
            edge_corners[t, e] = (tet[a], tet[b])

        corners = _CORNERS[tet].astype(np.float64)  # [4,3]

        def edge_mid(e):
            i, j = edge_pairs[e]
            return 0.5 * (corners[i] + corners[j])

        for case in range(1, 15):
            inside = [v for v in range(4) if case & (1 << v)]
            outside = [v for v in range(4) if not (case & (1 << v))]
            tris = []
            if len(inside) == 1:
                tris.append([edge_idx(inside[0], u) for u in outside])
            elif len(inside) == 3:
                tris.append([edge_idx(outside[0], u) for u in inside])
            else:
                s1, s2 = inside
                o1, o2 = outside
                e11, e12 = edge_idx(s1, o1), edge_idx(s1, o2)
                e21, e22 = edge_idx(s2, o1), edge_idx(s2, o2)
                tris.append([e11, e12, e22])
                tris.append([e11, e22, e21])

            # orient: normal should point inside -> outside
            ref_dir = corners[outside].mean(axis=0) - corners[inside].mean(axis=0)
            for k, tri in enumerate(tris):
                p0, p1, p2 = (edge_mid(e) for e in tri)
                if np.dot(np.cross(p1 - p0, p2 - p0), ref_dir) < 0:
                    tri = [tri[0], tri[2], tri[1]]
                tri_table[t, case, k] = tri
    return edge_corners, tri_table


_EDGE_CORNERS, _TRI_TABLE = _build_tet_tables()


def _build_face_lookup():
    """Per (tet, case): for each of the 6 triangle corners (2 tris x 3) the
    cell offset (ox, oy, oz in {0,1}) and canonical direction index of its
    edge, and the 2 triangle-validity flags.

    Returns (offs_dir [6,16,6,4] int64, valid [6,16,2] bool).
    """
    bit2dir = np.zeros(8, np.int64)
    for idx, d in enumerate(_DIRS):
        bit2dir[d[0] * 4 + d[1] * 2 + d[2]] = idx

    offs_dir = np.zeros((6, 16, 6, 4), np.int64)
    valid = np.zeros((6, 16, 2), bool)
    for t in range(6):
        for case in range(16):
            for tri in range(2):
                if _TRI_TABLE[t, case, tri, 0] < 0:
                    continue
                valid[t, case, tri] = True
                for v in range(3):
                    c1, c2 = _EDGE_CORNERS[t, _TRI_TABLE[t, case, tri, v]]
                    o1, o2 = _CORNERS[c1], _CORNERS[c2]
                    d = np.abs(o2 - o1)
                    offs_dir[t, case, tri * 3 + v, :3] = np.minimum(o1, o2)
                    offs_dir[t, case, tri * 3 + v, 3] = bit2dir[d[0] * 4 + d[1] * 2 + d[2]]
    return offs_dir, valid


_FACE_OFFS_DIR, _FACE_VALID = _build_face_lookup()
_TRI_COUNTS = np.count_nonzero(_TRI_TABLE[:, :, :, 0] >= 0, axis=2)  # [6,16]


class PaddedMesh(NamedTuple):
    """Fixed-capacity mesh."""

    verts: torch.Tensor       # [V_max, 3] float32; padded entries repeat verts[0]
    faces: torch.Tensor       # [F_max, 3] int64; padded faces = (0,0,0)
    vert_mask: torch.Tensor   # [V_max] float32
    face_mask: torch.Tensor   # [F_max] float32

    @property
    def num_verts(self) -> int:
        return int(self.vert_mask.sum().item())

    @property
    def num_faces(self) -> int:
        return int(self.face_mask.sum().item())


def _face_cross(mesh: PaddedMesh) -> torch.Tensor:
    tri = take_rows(mesh.verts, mesh.faces)
    return torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])


def face_normals(mesh: PaddedMesh, normalize: bool = True) -> torch.Tensor:
    n = _face_cross(mesh)
    if normalize:
        n = safe_normalize(n)
    return n * mesh.face_mask[:, None]


def vertex_normals(mesh: PaddedMesh) -> torch.Tensor:
    """Area-weighted vertex normals via a deterministic scatter-add
    (differentiable)."""
    fn = _face_cross(mesh) * mesh.face_mask[:, None]
    # corner-major, [3F]: a vertex sums its faces' normals as corner 0 of each,
    # then corner 1, then corner 2, in face order (the reference's order)
    vn = scatter_rows_add(mesh.verts.shape[0], mesh.faces.t().reshape(-1), fn.repeat(3, 1))
    return safe_normalize(vn)


def mesh_edges(faces: torch.Tensor, face_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[F,3] faces -> [3F,2] edges + mask (with duplicates; fine for the
    edge-length regularizer)."""
    e = torch.cat([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], dim=0)
    m = torch.cat([face_mask, face_mask, face_mask], dim=0)
    return e, m


def _signed_grid(sdf_grid: torch.Tensor, resolution: int, iso: float) -> torch.Tensor:
    n = resolution + 1
    return sdf_grid.reshape(n, n, n).float() - iso


def _active_edges(s: torch.Tensor) -> torch.Tensor:
    """[7,n,n,n] bool: the edge from each grid vertex along each of the 7
    directions changes sign (0 is its own sign). Edges that leave the grid meet
    a 1e9 border and are excluded."""
    n = s.shape[0]
    sp = torch.nn.functional.pad(s, (0, 1, 0, 1, 0, 1), value=1e9)
    ends = torch.stack([sp[d[0]:d[0] + n, d[1]:d[1] + n, d[2]:d[2] + n] for d in _DIRS])
    return (torch.sign(s)[None] != torch.sign(ends)) & (ends.abs() < 1e8)


def _tet_cases(s: torch.Tensor, resolution: int):
    """Per tet, the [C] case index (bit v set where tet corner v is inside)."""
    r = resolution
    ins = (s < 0).long()
    corner = [ins[c[0]:c[0] + r, c[1]:c[1] + r, c[2]:c[2] + r].reshape(-1) for c in _CORNERS]
    return [corner[tet[0]] + 2 * corner[tet[1]] + 4 * corner[tet[2]] + 8 * corner[tet[3]]
            for tet in _TETS]


def marching_tets(
    sdf_grid: torch.Tensor,
    bbox_min: torch.Tensor,
    bbox_max: torch.Tensor,
    resolution: int,
    max_verts: int = 32768,
    max_faces: int = 65536,
    iso: float = 0.0,
) -> PaddedMesh:
    """Extract the iso-surface of sdf_grid [(R+1)^3] (flattened, 'ij' order).

    sdf convention: NEGATIVE inside. Gradients flow to sdf_grid through the
    vertex interpolation weights. Geometry beyond max_verts / max_faces is
    dropped (see surface_capacity_counts).
    """
    n = resolution + 1
    dev = sdf_grid.device
    s = _signed_grid(sdf_grid, resolution, iso)
    bbox_min = torch.as_tensor(bbox_min, dtype=torch.float32, device=dev)
    bbox_max = torch.as_tensor(bbox_max, dtype=torch.float32, device=dev)
    step = (bbox_max - bbox_min) / resolution
    n_keys = n * n * n * 7

    # --- 1. active global edges -> vertex slots, ascending key order ---
    # key = vertex_index * 7 + dir_code, vertex_index = (i*n + j)*n + k
    active = _active_edges(s.detach())
    keys = active.permute(1, 2, 3, 0).reshape(-1).nonzero().squeeze(1)[:max_verts]
    n_active = keys.numel()
    vert_mask = (torch.arange(max_verts, device=dev) < n_active).float()
    edge_ids = torch.full((max_verts,), n_keys - 1, dtype=torch.long, device=dev)
    edge_ids[:n_active] = keys

    # keys beyond the capacity keep slot 0, as in the reference
    slot_of_key = torch.zeros(n_keys, dtype=torch.long, device=dev)
    slot_of_key[keys] = torch.arange(n_active, device=dev)

    vid = edge_ids // 7
    dcode = edge_ids % 7
    g1 = torch.stack([vid // (n * n), (vid // n) % n, vid % n], dim=-1)
    g2 = g1 + torch.as_tensor(_DIRS, device=dev)[dcode]
    g2c = g2.clamp(0, n - 1)
    # through take_rows: padded slots all gather the last key's vertex, and an
    # advanced-indexing gather's backward serialises such duplicates
    s_flat = s.reshape(-1)
    s1 = take_rows(s_flat, (g1[:, 0] * n + g1[:, 1]) * n + g1[:, 2])
    s2 = take_rows(s_flat, (g2c[:, 0] * n + g2c[:, 1]) * n + g2c[:, 2])
    denom = s1 - s2
    t = s1 / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    t = t.clamp(0.0, 1.0)
    p1 = bbox_min + g1.float() * step
    p2 = bbox_min + g2.float() * step
    verts = p1 + t[:, None] * (p2 - p1)
    # padded verts collapse to verts[0] so the bbox stays tight
    verts = torch.where(vert_mask[:, None] > 0, verts, verts[0])

    # --- 2. faces from tets: gather the per-case tables ---
    r = resolution
    cell = torch.arange(r, device=dev)
    ci, cj, ck = torch.meshgrid(cell, cell, cell, indexing="ij")
    cell_ijk = torch.stack([ci, cj, ck], dim=-1).reshape(-1, 1, 3)      # [C,1,3]
    offs_dir = torch.as_tensor(_FACE_OFFS_DIR, device=dev)               # [6,16,6,4]
    tri_valid = torch.as_tensor(_FACE_VALID, device=dev)                 # [6,16,2]

    all_faces, all_valid = [], []
    for tnum, case in enumerate(_tet_cases(s.detach(), resolution)):
        od = offs_dir[tnum][case]                                        # [C,6,4]
        g = cell_ijk + od[..., :3]
        key = ((g[..., 0] * n + g[..., 1]) * n + g[..., 2]) * 7 + od[..., 3]
        all_faces.append(slot_of_key[key].reshape(-1, 3))                # [2C,3]
        all_valid.append(tri_valid[tnum][case].reshape(-1))              # [2C]
    faces_cand = torch.cat(all_faces)
    valid_cand = torch.cat(all_valid)

    face_ids = valid_cand.nonzero().squeeze(1)[:max_faces]
    n_faces = face_ids.numel()
    face_mask = (torch.arange(max_faces, device=dev) < n_faces).float()
    faces = torch.zeros((max_faces, 3), dtype=torch.long, device=dev)
    faces[:n_faces] = faces_cand[face_ids]

    return PaddedMesh(verts=verts, faces=faces, vert_mask=vert_mask, face_mask=face_mask)


def surface_capacity_counts(sdf_grid: torch.Tensor, resolution: int,
                            iso: float = 0.0) -> Tuple[int, int]:
    """TRUE (pre-truncation) active-edge / face counts of marching_tets.

    The fixed-size compaction drops overflow silently, and dropped edges
    collapse faces onto vertex slot 0. Callers compare these counts against
    max_verts / max_faces to bring a capacity overrun to light."""
    s = _signed_grid(sdf_grid.detach(), resolution, iso)
    n_active = int(_active_edges(s).sum().item())
    tri_counts = torch.as_tensor(_TRI_COUNTS, device=s.device)
    n_faces = sum(int(tri_counts[tnum][case].sum().item())
                  for tnum, case in enumerate(_tet_cases(s, resolution)))
    return n_active, n_faces
