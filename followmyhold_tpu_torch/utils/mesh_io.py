"""Dependency-free mesh IO (PLY binary and ASCII, OBJ) and padded meshes.

The port's copy of followmyhold_tpu/utils/mesh_io.py. Meshes on the host are
numpy arrays; ``pad_mesh`` packs one into fixed-capacity buffers, as the
guidance targets' MoGe mesh is packed.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class HostMesh:
    """A host-side (numpy) triangle mesh."""

    vertices: np.ndarray  # [V, 3] float32
    faces: np.ndarray     # [F, 3] int32

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    @property
    def centroid(self) -> np.ndarray:
        return self.vertices.mean(axis=0)

    @property
    def scale(self) -> float:
        lo, hi = self.bounds()
        return float(np.linalg.norm(hi - lo))


def write_ply(path: str, vertices: np.ndarray, faces: Optional[np.ndarray] = None,
              binary: bool = True) -> None:
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    if faces is not None:
        faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    nv = vertices.shape[0]
    nf = 0 if faces is None else faces.shape[0]
    fmt = "binary_little_endian" if binary else "ascii"
    header = ["ply", f"format {fmt} 1.0", f"element vertex {nv}",
              "property float x", "property float y", "property float z"]
    if faces is not None:
        header += [f"element face {nf}", "property list uchar int vertex_indices"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            f.write(vertices.astype("<f4").tobytes())
            if faces is not None and nf:
                rec = np.empty(nf, dtype=[("n", "u1"), ("idx", "<i4", (3,))])
                rec["n"] = 3
                rec["idx"] = faces
                f.write(rec.tobytes())
        else:
            for v in vertices:
                f.write(f"{v[0]} {v[1]} {v[2]}\n".encode("ascii"))
            if faces is not None:
                for face in faces:
                    f.write(f"3 {face[0]} {face[1]} {face[2]}\n".encode("ascii"))


_PLY_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}


def read_ply(path: str) -> HostMesh:
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]
    body = body[body.find(b"\n") + 1:]

    fmt = "ascii"
    nv = nf = 0
    vertex_props: list = []
    current = None
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            current = tok[1]
            if tok[1] == "vertex":
                nv = int(tok[2])
            elif tok[1] == "face":
                nf = int(tok[2])
        elif tok[0] == "property" and current == "vertex" and tok[1] != "list":
            vertex_props.append((tok[2], tok[1]))

    if fmt == "ascii":
        text = body.decode("ascii").split("\n")
        verts = np.array([[float(x) for x in text[i].split()[:3]] for i in range(nv)],
                         dtype=np.float32).reshape(-1, 3)
        faces = np.array([[int(x) for x in text[nv + i].split()[1:4]] for i in range(nf)],
                         dtype=np.int32).reshape(-1, 3)
        return HostMesh(verts, faces)
    if fmt != "binary_little_endian":
        raise ValueError(f"{path}: unsupported PLY format {fmt}")

    vdtype = np.dtype([(name, _PLY_TYPES[t]) for name, t in vertex_props])
    varr = np.frombuffer(body, dtype=vdtype, count=nv)
    verts = np.stack([varr["x"], varr["y"], varr["z"]], axis=-1).astype(np.float32)
    faces = np.zeros((0, 3), np.int32)
    if nf:
        pos = nv * vdtype.itemsize
        # the common case, every face a triangle: one structured read
        tri = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
        if len(body) - pos >= nf * tri.itemsize:
            rec = np.frombuffer(body, dtype=tri, count=nf, offset=pos)
            if np.all(rec["n"] == 3):
                return HostMesh(verts, rec["idx"].astype(np.int32))
        out = np.empty((nf, 3), np.int32)
        for i in range(nf):
            (n,) = struct.unpack_from("B", body, pos)
            pos += 1
            out[i] = struct.unpack_from(f"<{n}i", body, pos)[:3]
            pos += 4 * n
        faces = out
    return HostMesh(verts, faces)


def write_obj(path: str, vertices: np.ndarray, faces: Optional[np.ndarray] = None) -> None:
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    with open(path, "w", encoding="ascii") as f:
        for v in vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if faces is not None:
            for face in np.asarray(faces, dtype=np.int64).reshape(-1, 3):
                f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def read_obj(path: str) -> HostMesh:
    verts, faces = [], []
    with open(path, "r", encoding="ascii", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif tok[0] == "f":
                faces.append([int(t.split("/")[0]) - 1 for t in tok[1:4]])
    return HostMesh(np.asarray(verts, dtype=np.float32).reshape(-1, 3),
                    np.asarray(faces, dtype=np.int32).reshape(-1, 3))


def load_mesh(path: str) -> HostMesh:
    if path.endswith(".ply"):
        return read_ply(path)
    if path.endswith(".obj"):
        return read_obj(path)
    raise ValueError(f"Unsupported mesh format: {path}")


def save_mesh(path: str, vertices: np.ndarray, faces: Optional[np.ndarray] = None) -> None:
    if path.endswith(".ply"):
        write_ply(path, vertices, faces)
    elif path.endswith(".obj"):
        write_obj(path, vertices, faces)
    else:
        raise ValueError(f"Unsupported mesh format: {path}")


def pad_mesh(mesh: HostMesh, max_verts: int, max_faces: int) -> Tuple[np.ndarray, np.ndarray,
                                                                       int, int]:
    """Pack a host mesh into fixed-capacity buffers -> (verts [max_verts,3],
    faces [max_faces,3], nv, nf). Padding vertices repeat vertex 0; padding
    faces are (0,0,0), which draw nothing. A mesh above the caps is truncated
    as the reference truncates it (the first vertices and faces kept, face
    indices clipped to the kept vertices), with a warning."""
    if mesh.num_vertices > max_verts or mesh.num_faces > max_faces:
        print(f"WARNING: pad_mesh: a mesh of {mesh.num_vertices} verts and {mesh.num_faces} "
              f"faces exceeds the caps {max_verts} / {max_faces}; it is truncated")
    nv = min(mesh.num_vertices, max_verts)
    nf = min(mesh.num_faces, max_faces)
    verts = np.zeros((max_verts, 3), np.float32)
    faces = np.zeros((max_faces, 3), np.int32)
    if nv:
        verts[:nv] = mesh.vertices[:nv]
        verts[nv:] = mesh.vertices[0]
    faces[:nf] = np.clip(mesh.faces[:nf], 0, max(nv - 1, 0))
    return verts, faces, nv, nf
