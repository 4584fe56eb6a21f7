"""Row gathers and row scatter-adds whose results do not depend on the run.

``x[index]`` with an integer tensor differentiates into ``index_put_`` with
accumulation, which sorts the indices and walks runs of duplicates serially.
The renderer gathers a face row for every pixel (262,144 rows out of 1,538
faces at 512x512), so nearly every index is a duplicate: measured with
torch.profiler on an H100, each such backward took 7.4 ms and seven of them
made up 95 % of a hand-pose iteration. ``index_select`` differentiates into
``index_add_``, whose float atomics on the card add duplicates in an order
that changes from run to run, so two calls of the same optimisation drift
apart.

``take_rows`` is ``index_select`` whose gradient is ``scatter_rows_add``: on a
CUDA tensor the kernel csrc/scatter_rows.cu, which adds in 64-bit fixed point
(integer sums do not depend on their order), with no float atomics and nothing
read back to the host. On a CPU tensor it is ``scatter_rows_add_plain``,
``index_add_`` in float64, which adds in index order there.

A batch of images takes per-image values and per-image sums through these
too (``repeat_per_image``, ``ops/losses.image_means``), so that each image's
numbers, gradients included, do not depend on which images share its batch:
cuBLAS's batched products and torch's reductions split their sums by the
batch size on the card, and a broadcast's gradient is such a reduction.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from followmyhold_tpu_torch.ops import _kernels


def scatter_rows_add_plain(n_rows: int, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain version: ``zeros(n_rows, ...).index_add_(0, index, src)``, added
    in float64 and rounded once, as the kernel's fixed point nearly is. It adds
    in index order on the CPU; on the card its atomics do not."""
    out = torch.zeros((n_rows, *src.shape[1:]), dtype=torch.float64, device=src.device)
    return out.index_add_(0, index.reshape(-1), src.double()).to(src.dtype)


def scatter_rows_add_forward(n_rows: int, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: index integer [N], src float32 [N, ...] on one CUDA
    device -> [n_rows, ...]; not recorded by autograd."""
    index = index.reshape(-1)
    n = index.numel()
    if not src.is_cuda or index.device != src.device:
        raise ValueError("the scatter kernel takes CUDA tensors on one device")
    if src.dtype != torch.float32:
        raise NotImplementedError(f"the scatter kernel takes float32, got {src.dtype}")
    if src.shape[0] != n:
        raise ValueError(f"src has {src.shape[0]} rows for {n} indices")
    out = torch.empty((n_rows, *src.shape[1:]), dtype=torch.float32, device=src.device)
    cols = 1
    for d in src.shape[1:]:
        cols *= d
    if n_rows == 0 or cols == 0:
        return out
    if n == 0:
        return out.zero_()
    rows = src.reshape(n, cols).contiguous()
    index = index.to(torch.int64).contiguous()
    # 64-bit fixed-point accumulators [n_rows * cols], then each row's largest
    # |term| and NaN flag (see csrc/scatter_rows.cu)
    scratch = torch.empty(n_rows * (cols + 1), dtype=torch.int64, device=src.device)
    lib = _kernels.load_library()
    with torch.cuda.device(src.device):
        code = lib.fmh_scatter_rows_add(index.data_ptr(), rows.data_ptr(), out.data_ptr(),
                                        scratch.data_ptr(), n, n_rows, cols,
                                        torch.cuda.current_stream().cuda_stream)
    _kernels.check_launch(code, "scatter_rows_add")
    _kernels.LAUNCH_COUNTS["scatter_rows_add"] += 1
    return out


class _ScatterRowsAdd(torch.autograd.Function):
    """The kernel under autograd; its backward is a gather."""

    @staticmethod
    def forward(ctx, n_rows, index, src):
        ctx.save_for_backward(index)
        ctx.src_shape = src.shape
        return scatter_rows_add_forward(n_rows, index, src)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        return None, None, grad.index_select(0, index.reshape(-1)).reshape(ctx.src_shape)


def scatter_rows_add(n_rows: int, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``zeros(n_rows, *src.shape[1:]).index_add_(0, index, src)``, summed in
    an order that does not change from run to run. ``index`` is an integer
    [N], ``src`` is [N, ...]; differentiable with respect to ``src``. The
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    index = index.reshape(-1)
    if src.shape[0] != index.numel():
        raise ValueError(f"src has {src.shape[0]} rows for {index.numel()} indices")
    if not src.is_cuda:
        return scatter_rows_add_plain(n_rows, index, src)
    if torch.is_grad_enabled() and src.requires_grad:
        return _ScatterRowsAdd.apply(n_rows, index, src)
    return scatter_rows_add_forward(n_rows, index, src)   # e.g. inside take_rows' backward


class _TakeRows(torch.autograd.Function):
    """``index_select`` along dim 0 whose backward is ``scatter_rows_add``."""

    @staticmethod
    def forward(ctx, x, index):
        ctx.save_for_backward(index)
        ctx.n_rows = x.shape[0]
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        return scatter_rows_add(ctx.n_rows, index, grad), None


def take_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` along dim 0 for an integer ``index`` of any shape; its
    gradient is a deterministic scatter-add."""
    out = _TakeRows.apply(x, index.reshape(-1))
    return out.reshape(*index.shape, *x.shape[1:])


def take_image_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Per image b of a batch, rows ``index[b]`` of ``x[b]``: x [B,N,...], index
    [B,...] integer -> [B, *index.shape[1:], ...]. One ``take_rows`` over the
    images' rows laid end to end, so its gradient is the same scatter."""
    B, N = x.shape[:2]
    offsets = image_offsets(B, N, index.device).reshape(B, *([1] * (index.dim() - 1)))
    return take_rows(x.reshape(B * N, *x.shape[2:]), index + offsets)


@functools.lru_cache(maxsize=32)
def image_offsets(n_images: int, n: int, device: torch.device) -> torch.Tensor:
    """[n_images] int64: b * n, the first row of image b where images of n
    rows each lie end to end; made once for each shape, never written to."""
    return torch.arange(n_images, device=device) * n


@functools.lru_cache(maxsize=32)
def image_rows(n_images: int, n: int, device: torch.device) -> torch.Tensor:
    """[n_images * n] int64: 0 n times, then 1 n times, ...; made once for
    each shape (an iteration asks for the same few), never written to."""
    return torch.arange(n_images, device=device).repeat_interleave(n)


def repeat_per_image(x: torch.Tensor, n: int) -> torch.Tensor:
    """Each image's value x[b] (x [B, ...]) on each of its n points or pixels:
    [B, n, ...]. A gather, so the gradient of each image's value is a
    ``scatter_rows_add`` over its own points: a sum that does not depend on
    which images share the batch, where a broadcast's gradient is a torch
    reduction whose split follows the batch size."""
    B = x.shape[0]
    return take_rows(x, image_rows(B, n, x.device)).reshape(B, n, *x.shape[1:])


def first_per_image(present: torch.Tensor, cap: int, total: Optional[int] = None):
    """Each image's first ``cap`` set entries of ``present`` [B,N] bool, in
    ascending order: (image, entry, slot), where slot is the entry's rank within
    its image, or ``cap`` (a slot past the buffer) for an entry beyond the cap;
    and each image's true count [B]. One host read, the nonzero's, sizes it all;
    none where the caller has read the set entries' ``total`` already."""
    if total is None:
        img, idx = present.nonzero(as_tuple=True)
    else:
        img, idx = torch.nonzero_static(present, size=total).unbind(1)
    count = present.sum(dim=1)
    first = torch.cumsum(count, 0) - count
    rank = torch.arange(img.numel(), device=present.device) - first[img]
    return img, idx, torch.where(rank < cap, rank, torch.full_like(rank, cap)), count
