"""The yardstick's arithmetic: one H100's published peaks and the operations
and bytes of the calls the benchmark counts.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full 700 W power limit (a card set below it runs slower; the result line's
card name and the power limit in PERF.md go beside every share).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12     # bf16 / fp16 tensor-core rate, dense
PEAK_HBM_BYTES = 3.35e12     # HBM3 bandwidth


def attention_forward_flops(B: int, H: int, N: int, M: int, D: int) -> float:
    """QK^T and PV of unmasked attention: 2 matrix products of 2*N*M*D."""
    return 4.0 * B * H * N * M * D


def attention_backward_flops(B: int, H: int, N: int, M: int, D: int) -> float:
    """dV, dP, dQ and dK: twice the forward (the recomputed QK^T not counted)."""
    return 8.0 * B * H * N * M * D


def attention_forward_bytes(B: int, H: int, N: int, M: int, D: int, itemsize: int) -> float:
    """Q, K and V read once and O written once, plus the float32 logsumexp."""
    return float(itemsize) * B * H * (2 * N * D + 2 * M * D) + 4.0 * B * H * N


def attention_forward_bound_s(B: int, H: int, N: int, M: int, D: int, itemsize: int) -> float:
    """The least time one H100 could take for the forward: the larger of its
    operations at the bf16 peak and its bytes at the HBM peak."""
    return max(attention_forward_flops(B, H, N, M, D) / PEAK_BF16_FLOPS,
               attention_forward_bytes(B, H, N, M, D, itemsize) / PEAK_HBM_BYTES)


def linear_flops(rows: int, n_in: int, n_out: int) -> float:
    """A matrix product of ``rows`` inputs of ``n_in`` into ``n_out``."""
    return 2.0 * rows * n_in * n_out


def conv_flops(out_elems: int, n_in_per_group: int, kernel_elems: int) -> float:
    """A convolution: each output element sums n_in/groups x kernel products."""
    return 2.0 * out_elems * n_in_per_group * kernel_elems
