"""Marching tetrahedra and mesh helpers of the PyTorch port against the JAX
package, slot for slot: the port keeps the output contract (verts in ascending
edge-key order, faces in candidate order, padded verts = verts[0], padded
faces = 0), so no canonicalisation is needed.

All cases stay below the vertex and face capacities. Tolerance 1e-6: the same
float32 interpolation on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from followmyhold_tpu.ops import surface as jsurf
from followmyhold_tpu_torch.ops import surface as tsurf

RES = 10
BOX = 1.1


def _grid(res=RES):
    ax = np.linspace(-BOX, BOX, res + 1, dtype=np.float32)
    return np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)


def _fields():
    p = _grid()
    sphere = np.linalg.norm(p, axis=-1) - 0.7
    # non-convex: two overlapping blobs with a ripple, plus exact zeros on the grid
    blobs = np.minimum(np.linalg.norm(p - [0.35, 0.1, 0.0], axis=-1) - 0.45,
                       np.linalg.norm(p + [0.3, 0.0, 0.2], axis=-1) - 0.4)
    blobs = blobs + 0.05 * np.sin(6 * p[:, 0]) * np.cos(5 * p[:, 1])
    blobs[np.abs(blobs) < 0.01] = 0.0
    return {"sphere": sphere.astype(np.float32), "blobs": blobs.astype(np.float32)}


def _both(sdf, max_verts=2048, max_faces=4096):
    lo, hi = [-BOX] * 3, [BOX] * 3
    jm = jsurf.marching_tets(jnp.asarray(sdf), jnp.asarray(lo), jnp.asarray(hi), RES,
                             max_verts=max_verts, max_faces=max_faces)
    tm = tsurf.marching_tets(torch.from_numpy(sdf), lo, hi, RES,
                             max_verts=max_verts, max_faces=max_faces)
    return jm, tm


@pytest.mark.parametrize("name", ["sphere", "blobs"])
def test_marching_tets_matches_slot_for_slot(name):
    sdf = _fields()[name]
    jm, tm = _both(sdf)
    nv, nf = int(jm.num_verts), int(jm.num_faces)
    assert 0 < nv < 2048 and 0 < nf < 4096          # below the caps
    assert (tm.num_verts, tm.num_faces) == (nv, nf)
    np.testing.assert_array_equal(tm.vert_mask.numpy(), np.asarray(jm.vert_mask))
    np.testing.assert_array_equal(tm.face_mask.numpy(), np.asarray(jm.face_mask))
    np.testing.assert_array_equal(tm.faces.numpy(), np.asarray(jm.faces))
    np.testing.assert_allclose(tm.verts.numpy(), np.asarray(jm.verts), atol=1e-6)
    assert tm.verts.shape == (2048, 3) and tm.faces.shape == (4096, 3)


def test_marching_tets_empty_field_matches():
    sdf = np.ones((RES + 1) ** 3, np.float32)
    jm, tm = _both(sdf, 64, 128)
    assert tm.num_verts == 0 and tm.num_faces == 0
    np.testing.assert_array_equal(tm.faces.numpy(), np.asarray(jm.faces))
    np.testing.assert_allclose(tm.verts.numpy(), np.asarray(jm.verts), atol=1e-6)


def test_marching_tets_truncates_like_the_reference():
    sdf = _fields()["sphere"]
    jm, tm = _both(sdf, 100, 150)
    assert tm.num_verts == 100 and tm.num_faces == 150
    np.testing.assert_array_equal(tm.faces.numpy(), np.asarray(jm.faces))
    np.testing.assert_allclose(tm.verts.numpy(), np.asarray(jm.verts), atol=1e-6)


def test_marching_tets_gradient_to_the_sdf_matches():
    sdf = _fields()["sphere"]
    w = np.random.default_rng(0).normal(size=(2048, 3)).astype(np.float32)

    def jloss(s):
        m = jsurf.marching_tets(s, jnp.asarray([-BOX] * 3), jnp.asarray([BOX] * 3), RES,
                                max_verts=2048, max_faces=4096)
        return jnp.sum(m.verts * m.vert_mask[:, None] * w)

    want = jax.grad(jloss)(jnp.asarray(sdf))
    st = torch.from_numpy(sdf).requires_grad_(True)
    m = tsurf.marching_tets(st, [-BOX] * 3, [BOX] * 3, RES, max_verts=2048, max_faces=4096)
    (m.verts * m.vert_mask[:, None] * torch.from_numpy(w)).sum().backward()
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want), atol=1e-5 * scale)


@pytest.mark.parametrize("name", ["sphere", "blobs"])
def test_surface_capacity_counts_match(name):
    sdf = _fields()[name]
    ja, jf = jsurf.surface_capacity_counts(jnp.asarray(sdf), RES)
    ta, tf = tsurf.surface_capacity_counts(torch.from_numpy(sdf), RES)
    assert (ta, tf) == (int(ja), int(jf))
    jm, _ = _both(sdf)
    assert (ta, tf) == (int(jm.num_verts), int(jm.num_faces))


def test_normals_and_edges_match():
    jm, tm = _both(_fields()["blobs"])
    np.testing.assert_allclose(tsurf.vertex_normals(tm).numpy(),
                               np.asarray(jsurf.vertex_normals(jm)), atol=2e-5)
    np.testing.assert_allclose(tsurf.face_normals(tm).numpy(),
                               np.asarray(jsurf.face_normals(jm)), atol=2e-5)
    np.testing.assert_allclose(tsurf.face_normals(tm, normalize=False).numpy(),
                               np.asarray(jsurf.face_normals(jm, normalize=False)), atol=1e-6)
    je, jmask = jsurf.mesh_edges(jm.faces, jm.face_mask)
    te, tmask = tsurf.mesh_edges(tm.faces, tm.face_mask)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_vertex_normals_gradient_matches():
    jm, tm = _both(_fields()["sphere"])
    w = np.random.default_rng(1).normal(size=(2048, 3)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jsurf.vertex_normals(jm._replace(verts=v)) * w))(jm.verts)
    vt = tm.verts.clone().requires_grad_(True)
    (tsurf.vertex_normals(tm._replace(verts=vt)) * torch.from_numpy(w)).sum().backward()
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(want), atol=1e-4 * scale)
