"""Mesh post-processors of the export: floater removal, degenerate-face
removal, face reduction.

Counterpart of followmyhold_tpu/geometry/postprocess.py (itself standing in
for hy3dgen's FloaterRemover, DegenerateFaceRemover and FaceReducer). Host
code: they run once per exported mesh, on the native library
(``followmyhold_tpu_torch/native``), which raises if it cannot be built. The
NumPy functions named ``*_plain`` are the reference's NumPy paths, kept as the
plain versions that the tests hold the native ones against.

Two faults of the reference are not copied:
- its grid decimation halves the grid down to 2 cells when the face budget is
  not met, which collapses a mesh to a few faces; here the loop stops at
  ``_GRID_FLOOR`` cells and returns that best-effort mesh with a warning;
- (a note, not a change) the quadric decimation assumes a closed input and
  adds no boundary quadrics; the marching-tets export is closed wherever it
  stays inside the decode box, and ``reduce_faces`` says so where it calls it.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from followmyhold_tpu_torch import native

# the coarsest grid that reduce_faces' grid decimation goes down to
_GRID_FLOOR = 8


def connected_components_plain(num_verts: int, faces: np.ndarray) -> np.ndarray:
    """Union-find over face edges -> component label per vertex (NumPy/Python;
    the plain version of ``native.connected_components``)."""
    parent = np.arange(num_verts)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for f in faces:
        r0 = find(f[0])
        for v in f[1:]:
            r = find(v)
            if r != r0:
                parent[r] = r0
    return np.array([find(i) for i in range(num_verts)])


def _sanitize(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Drop faces with out-of-range vertex ids (a truncated export can leave a
    face pointing past the last vertex)."""
    if len(faces) == 0:
        return faces
    ok = (faces >= 0).all(axis=1) & (faces < len(verts)).all(axis=1)
    return faces if ok.all() else faces[ok]


def _compact(verts: np.ndarray, faces: np.ndarray,
             keep_vert: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    remap = np.full(len(verts), -1, np.int64)
    remap[keep_vert] = np.arange(int(keep_vert.sum()))
    face_ok = keep_vert[faces].all(axis=1)
    return verts[keep_vert], remap[faces[face_ok]].astype(np.int32)


def remove_floaters(verts: np.ndarray, faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Keep only the largest connected component."""
    faces = _sanitize(verts, faces)
    if len(faces) == 0:
        return verts, faces
    labels, main = native.connected_components(len(verts), faces)
    return _compact(verts, faces, labels == main)


def remove_degenerate_faces(verts: np.ndarray, faces: np.ndarray,
                            eps: float = 1e-12) -> Tuple[np.ndarray, np.ndarray]:
    """Drop zero-area and repeated-index faces, then unused vertices."""
    faces = _sanitize(verts, faces)
    if len(faces) == 0:
        return verts, faces
    tri = verts[faces]
    area2 = np.sum(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]) ** 2, -1)
    distinct = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                & (faces[:, 0] != faces[:, 2]))
    faces = faces[(area2 > eps) & distinct]
    used = np.zeros(len(verts), bool)
    used[faces.reshape(-1)] = True
    return _compact(verts, faces, used)


def decimate_grid_plain(verts: np.ndarray, faces: np.ndarray,
                        res: int) -> Tuple[np.ndarray, np.ndarray]:
    """Vertex clustering on a res-cell grid over the mesh's largest extent,
    in NumPy: the plain version of ``native.decimate_grid``."""
    lo, hi = verts.min(0), verts.max(0)
    cell = (hi - lo).max() / res
    key = np.floor((verts - lo) / max(cell, 1e-12)).astype(np.int64)
    key = key[:, 0] * (res + 1) ** 2 + key[:, 1] * (res + 1) + key[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    new_verts = np.zeros((len(uniq), 3), np.float64)
    np.add.at(new_verts, inv, verts)
    new_verts /= np.bincount(inv)[:, None]
    new_faces = inv[faces]
    distinct = ((new_faces[:, 0] != new_faces[:, 1]) & (new_faces[:, 1] != new_faces[:, 2])
                & (new_faces[:, 0] != new_faces[:, 2]))
    new_faces = new_faces[distinct]
    _, first = np.unique(np.sort(new_faces, axis=1), axis=0, return_index=True)
    new_faces = new_faces[np.sort(first)]
    return new_verts.astype(np.float32), new_faces.astype(np.int32)


def reduce_faces(verts: np.ndarray, faces: np.ndarray, max_faces: int = 40000,
                 method: str = None) -> Tuple[np.ndarray, np.ndarray]:
    """Decimate until at most ``max_faces`` remain.

    method: "quadric" (default) is Garland-Heckbert edge collapse; it moves
    only the cheapest vertices. It assumes a closed (watertight) mesh, as the
    export's marching-tets surface is wherever it stays inside the decode box:
    it has no boundary quadrics, so an open boundary may shrink. Inputs above ``FOHO_QUADRIC_PRECLUSTER`` faces
    (600,000) are first clustered on a 256-cell grid. "grid" is vertex
    clustering, halving the grid from 256 cells until the budget is met, but
    not below ``_GRID_FLOOR`` cells: there it returns its best-effort mesh and
    warns. ``FOHO_REDUCE_METHOD`` overrides the default."""
    faces = _sanitize(verts, faces)
    if len(faces) <= max_faces:
        return verts, faces
    method = method or os.environ.get("FOHO_REDUCE_METHOD", "quadric")
    if method == "quadric":
        pre_thresh = int(os.environ.get("FOHO_QUADRIC_PRECLUSTER", "600000"))
        if len(faces) > max(pre_thresh, 8 * max_faces):
            lo, hi = verts.min(0), verts.max(0)
            g = native.decimate_grid(verts, faces, float((hi - lo).max() / 256))
            if len(g[1]) > max_faces:
                verts, faces = g
        # decimate_quadric adds no boundary quadrics: it assumes a closed mesh
        out = native.decimate_quadric(verts, faces, max_faces)
        if out is not None:
            return out
        print(f"WARNING: quadric decimation refused the mesh ({len(verts)} verts, "
              f"{len(faces)} faces); reducing on a grid instead")

    lo, hi = verts.min(0), verts.max(0)
    res = 256
    while True:
        new_verts, new_faces = native.decimate_grid(verts, faces, float((hi - lo).max() / res))
        if len(new_faces) <= max_faces:
            return new_verts, new_faces
        if res // 2 < _GRID_FLOOR:
            print(f"WARNING: reduce_faces: {len(new_faces)} faces remain on a {res}-cell "
                  f"grid, above the budget of {max_faces}; returning that mesh")
            return new_verts, new_faces
        res //= 2
