"""The port's row gather and its deterministic scatter-add (ops/indexing.py).

``take_rows`` is ``x[index]`` whose gradient is ``scatter_rows_add``, a sum
over the rows that share an index taken in a fixed order: on a CPU tensor its
plain version, on a CUDA tensor the kernel that chip_smoke.py holds against
it. Both are held against ``x[index]`` under autograd and a float64
``index_add_``, with heavy duplicates as the renderer's per-pixel gathers have
them: to 1e-6 of each output row's sum of magnitudes (float32 sums of some
10^3 terms in another order; measured about 1e-7), and two calls give the
same bits.
"""

import numpy as np
import pytest
import torch

from followmyhold_tpu_torch.ops.indexing import scatter_rows_add, take_rows
from followmyhold_tpu_torch.ops.safe import safe_normalize
from followmyhold_tpu_torch.ops.surface import PaddedMesh, vertex_normals


def _duplicated(seed, n=4000, n_rows=9, row_shape=(3, 3)):
    """Indices into n_rows with heavy duplicates (one row takes every 7th
    entry, the last rows none) and float32 sources."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows - 3, size=n)
    idx[::7] = 2
    src = rng.normal(size=(n, *row_shape)).astype(np.float32)
    return torch.from_numpy(idx), torch.from_numpy(src)


def _row_scale(n_rows, idx, src):
    """Each output row's sum of |src|: the scale of its rounding error."""
    return torch.zeros((n_rows, *src.shape[1:]), dtype=torch.float64).index_add_(
        0, idx, src.double().abs())


@pytest.mark.parametrize("seed, row_shape", [(0, (3, 3)), (1, (9,)), (2, ())],
                         ids=["rows3x3", "rows9", "scalars"])
def test_scatter_rows_add_matches_index_add(seed, row_shape):
    idx, src = _duplicated(seed, row_shape=row_shape)
    got = scatter_rows_add(9, idx, src)
    want = torch.zeros((9, *row_shape), dtype=torch.float64).index_add_(0, idx, src.double())
    assert got.shape == (9, *row_shape) and got.dtype == torch.float32
    assert ((got.double() - want).abs() <= 1e-6 * _row_scale(9, idx, src)).all()
    assert (got[-3:] == 0).all()                     # rows no index names stay zero
    assert torch.equal(got, scatter_rows_add(9, idx, src))


def test_scatter_rows_add_is_differentiable():
    idx, src = _duplicated(3)
    src.requires_grad_(True)
    g = torch.randn(9, 3, 3, generator=torch.Generator().manual_seed(0))
    (scatter_rows_add(9, idx, src) * g).sum().backward()
    assert torch.equal(src.grad, g[idx])             # the backward is a gather


def test_scatter_rows_add_checks_lengths():
    with pytest.raises(ValueError, match="rows"):
        scatter_rows_add(4, torch.zeros(5, dtype=torch.long), torch.zeros(4, 3))


@pytest.mark.parametrize("index_shape", [(4000,), (40, 10, 10)], ids=["flat", "pixels"])
def test_take_rows_gradient_matches_advanced_indexing(index_shape):
    idx, _ = _duplicated(4, n=int(np.prod(index_shape)))
    idx = idx.reshape(index_shape)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(9, 3, 3, generator=gen, requires_grad=True)
    g = torch.randn(*index_shape, 3, 3, generator=gen)

    out = take_rows(x, idx)
    assert torch.equal(out, x[idx])
    (got,) = torch.autograd.grad((out * g).sum(), x)
    (want,) = torch.autograd.grad((x[idx] * g).sum(), x)
    scale = _row_scale(9, idx.reshape(-1), g.reshape(-1, 3, 3))
    assert ((got.double() - want.double()).abs() <= 1e-6 * scale + 1e-12).all()
    (again,) = torch.autograd.grad((take_rows(x, idx) * g).sum(), x)
    assert torch.equal(got, again)


def test_take_rows_takes_int32_indices():
    x = torch.arange(12.0).reshape(6, 2).requires_grad_(True)
    idx = torch.tensor([[5, 0], [5, 5]], dtype=torch.int32)
    out = take_rows(x, idx)
    assert torch.equal(out, x.detach()[idx.long()])
    out.sum().backward()
    assert torch.equal(x.grad[:, 0], torch.tensor([1.0, 0, 0, 0, 0, 3]))


def test_vertex_normals_match_per_corner_index_add():
    """vertex_normals sums each face's normal into its three corners through
    scatter_rows_add, corner-major as the three index_adds it replaced did:
    on the CPU, where those add in order, the bits are the same."""
    rng = np.random.default_rng(6)
    verts = torch.from_numpy(rng.normal(size=(30, 3)).astype(np.float32))
    faces = torch.from_numpy(rng.integers(0, 30, size=(80, 3)))
    mask = torch.from_numpy((rng.uniform(size=80) > 0.2).astype(np.float32))
    mesh = PaddedMesh(verts, faces, torch.ones(30), mask)
    got = vertex_normals(mesh)
    tri = verts[faces]
    fn = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]) * mask[:, None]
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn = vn.index_add(0, faces[:, k], fn)
    assert torch.equal(got, safe_normalize(vn))


def test_cpu_tensors_take_the_plain_version_and_the_kernel_wrapper_refuses_them():
    from followmyhold_tpu_torch.ops import _kernels
    from followmyhold_tpu_torch.ops.indexing import (scatter_rows_add_forward,
                                                     scatter_rows_add_plain)

    idx, src = _duplicated(5)
    before = _kernels.launch_counts()["scatter_rows_add"]
    assert torch.equal(scatter_rows_add(9, idx, src), scatter_rows_add_plain(9, idx, src))
    assert _kernels.launch_counts()["scatter_rows_add"] == before   # no launch on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        scatter_rows_add_forward(9, idx, src)
