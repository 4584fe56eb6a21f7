"""Native (C++) host-side mesh operations, loaded through ctypes.

``mesh_ops.cpp`` is built with ``g++`` at first use into ``build/`` beside the
package (ignored by git), under a name that carries a hash of the source and
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import time. A failed build raises: the callers do not
fall back to the NumPy versions, which stay as the plain versions that the
tests hold these functions against (``geometry/postprocess.py``,
``ops/surface.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "mesh_ops.cpp"
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_lib: Optional[ctypes.CDLL] = None


def build_dir() -> Path:
    """``build/`` at the root of the checkout, as for the CUDA kernels."""
    return _SRC.parent.parent.parent / "build"


def build_library() -> Path:
    """Compile ``mesh_ops.cpp`` unless this source's library exists; raise if
    ``g++`` fails or is missing."""
    digest = hashlib.sha1(_SRC.read_bytes() + repr(_FLAGS).encode()).hexdigest()[:16]
    lib_path = build_dir() / f"libfmh_mesh_ops_{digest}.so"
    if lib_path.exists():
        return lib_path
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native mesh operations are built at "
                           "first use") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {_SRC.name} failed:\n{proc.stderr}")
    os.replace(tmp, lib_path)   # atomic: a concurrent build sees all or nothing
    return lib_path


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.connected_components.restype = ctypes.c_int32
    lib.connected_components.argtypes = [ctypes.c_int32, ctypes.c_int32, i32p, i32p]
    lib.compact_mesh.restype = ctypes.c_int32
    lib.compact_mesh.argtypes = [ctypes.c_int32, ctypes.c_int32, i32p, u8p, i32p, i32p]
    lib.decimate_grid.restype = ctypes.c_int32
    lib.decimate_grid.argtypes = [ctypes.c_int32, ctypes.c_int32, f32p, i32p,
                                  ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                  ctypes.c_float, f32p, i32p, i32p]
    lib.decimate_quadric.restype = ctypes.c_int32
    lib.decimate_quadric.argtypes = [ctypes.c_int32, ctypes.c_int64, f32p,
                                     i32p, ctypes.c_int64, f32p, i32p, i32p]
    lib.marching_tets_cells.restype = ctypes.c_int32
    lib.marching_tets_cells.argtypes = [
        ctypes.c_int32, f32p, ctypes.c_int64, i32p, i32p, i32p, i32p,
        ctypes.c_int32, i32p, i32p, i32p, f64p, f64p, f32p, i32p, i64p,
        ctypes.c_int64, ctypes.c_int64]
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _i32(a: np.ndarray):
    return _ptr(a, ctypes.c_int32)


def connected_components(n_verts: int, faces: np.ndarray) -> Tuple[np.ndarray, int]:
    """-> (component label of every vertex, the largest component's label)."""
    lib = get_lib()
    faces = np.ascontiguousarray(faces, np.int32)
    labels = np.empty(n_verts, np.int32)
    best = lib.connected_components(n_verts, len(faces), _i32(faces), _i32(labels))
    return labels, int(best)


def compact_mesh(verts: np.ndarray, faces: np.ndarray,
                 keep: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the vertices marked in ``keep`` and the faces whose corners are all
    kept, renumbered."""
    lib = get_lib()
    faces = np.ascontiguousarray(faces, np.int32)
    keep8 = np.ascontiguousarray(keep, np.uint8)
    out_faces = np.empty_like(faces)
    remap = np.empty(len(verts), np.int32)
    nf = lib.compact_mesh(len(verts), len(faces), _i32(faces), _ptr(keep8, ctypes.c_uint8),
                          _i32(out_faces), _i32(remap))
    return verts[keep.astype(bool)], out_faces[:nf].copy()


def marching_tets_cells(s3: np.ndarray, cells: np.ndarray, tets: np.ndarray,
                        tri_table: np.ndarray, edge_corners: np.ndarray,
                        corners: np.ndarray, dirs: np.ndarray,
                        bit2dir: np.ndarray, bbox_min: np.ndarray,
                        step: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cell marching-tets emission (the hot loop of
    ``ops/surface.marching_tets_host``); the tables come from the caller, so
    Python stays their single source. -> (verts, faces)."""
    lib = get_lib()
    s3 = np.ascontiguousarray(s3, np.float32)
    cells = np.ascontiguousarray(cells, np.int32)
    max_f = max(int(len(cells)) * 12, 1)
    # a cell touches <= 19 distinct edges (12 cube + 6 face diagonals + 1 body)
    max_v = max(int(len(cells)) * 19, 1)
    out_verts = np.empty((max_v, 3), np.float32)
    out_faces = np.empty((max_f, 3), np.int32)
    counts = np.zeros(2, np.int64)
    rc = lib.marching_tets_cells(
        s3.shape[0], _ptr(s3, ctypes.c_float), len(cells), _i32(cells),
        _i32(np.ascontiguousarray(tets, np.int32)),
        _i32(np.ascontiguousarray(tri_table, np.int32)),
        _i32(np.ascontiguousarray(edge_corners, np.int32)), int(edge_corners.shape[1]),
        _i32(np.ascontiguousarray(corners, np.int32)),
        _i32(np.ascontiguousarray(dirs, np.int32)),
        _i32(np.ascontiguousarray(bit2dir, np.int32)),
        _ptr(np.ascontiguousarray(bbox_min, np.float64), ctypes.c_double),
        _ptr(np.ascontiguousarray(step, np.float64), ctypes.c_double),
        _ptr(out_verts, ctypes.c_float), _i32(out_faces),
        _ptr(counts, ctypes.c_int64), max_v, max_f)
    if rc != 0:
        raise RuntimeError(f"marching_tets_cells overflowed its buffers (code {rc})")
    return out_verts[: int(counts[0])].copy(), out_faces[: int(counts[1])].copy()


def decimate_quadric(verts: np.ndarray, faces: np.ndarray,
                     target_faces: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Quadric edge-collapse decimation to <= target_faces. Assumes a closed
    (watertight) mesh: no boundary quadrics. -> (verts, faces), or None when
    the input is malformed (an empty mesh or an index out of range)."""
    lib = get_lib()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    out_verts = np.empty_like(verts)
    out_faces = np.empty_like(faces)
    n_out = np.zeros(1, np.int32)
    nf = lib.decimate_quadric(len(verts), len(faces), _ptr(verts, ctypes.c_float),
                              _i32(faces), int(target_faces), _ptr(out_verts, ctypes.c_float),
                              _i32(out_faces), _i32(n_out))
    if nf < 0:
        return None
    return out_verts[: int(n_out[0])].copy(), out_faces[:nf].copy()


def decimate_grid(verts: np.ndarray, faces: np.ndarray,
                  cell: float) -> Tuple[np.ndarray, np.ndarray]:
    """Vertex clustering on a grid of ``cell``-sized cubes from the mesh's
    lower corner; collapsed and repeated faces are dropped."""
    lib = get_lib()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    lo = verts.min(axis=0) if len(verts) else np.zeros(3, np.float32)
    out_verts = np.empty_like(verts)
    out_faces = np.empty_like(faces)
    n_out = np.zeros(1, np.int32)
    nf = lib.decimate_grid(
        len(verts), len(faces), _ptr(verts, ctypes.c_float), _i32(faces),
        ctypes.c_float(cell), ctypes.c_float(float(lo[0])), ctypes.c_float(float(lo[1])),
        ctypes.c_float(float(lo[2])), _ptr(out_verts, ctypes.c_float), _i32(out_faces),
        _i32(n_out))
    return out_verts[: int(n_out[0])].copy(), out_faces[:nf].copy()
