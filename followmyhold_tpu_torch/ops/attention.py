"""Attention: a hand-written flash-attention forward for Hopper plus its plain
PyTorch version.

Counterpart of followmyhold_tpu/ops/attention.py. Every attention on the
guided sampler's path (DiT joint attention, ShapeVAE self-attention, the
geo-decoder's cross-attention) goes through ``multi_head_attention``, which
keeps the reference's gate: the kernel runs for unmasked sequences of at least
256 queries with a head size up to 128, the plain version otherwise.

The kernel (csrc/flash_attention_fwd.cu) is forward only: under autograd the
flash path raises, because the backward kernel is not ported yet.

Layout: [B, H, N, D].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from followmyhold_tpu_torch.ops import _kernels
from followmyhold_tpu_torch.utils.device import DeviceLike, resolve_device

_KERNEL_HEAD_SIZES = (64, 128)


def _logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    # f32 products of the stored values, as the kernel's f32 accumulators hold
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention: f32 logits and softmax, weights cast to v's type for
    the second product, result in q's type. ``mask`` is True where attended."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = _logits(q, k, scale)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype), v).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (out [B,H,N,D], logsumexp [B,H,N] f32)."""
    logits = _logits(q, k, scale)
    lse = torch.logsumexp(logits, dim=-1)
    weights = torch.exp(logits - lse[..., None])
    return torch.matmul(weights.to(v.dtype), v).to(q.dtype), lse


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, logsumexp) of unmasked attention.

    CUDA tensors launch the kernel or raise; CPU tensors take the plain
    version. The kernel takes contiguous bf16 [B,H,N,D] / [B,H,M,D] with D in
    {64, 128}; N and M may be ragged.
    """
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected [B,H,N,D] and [B,H,M,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, N, D = q.shape
    M = k.shape[2]
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D or M < 1 or N < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    if D not in _KERNEL_HEAD_SIZES:
        raise NotImplementedError(
            f"flash-attention kernel is built for head sizes {_KERNEL_HEAD_SIZES}, got {D}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise NotImplementedError(
            f"flash-attention kernel takes bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "the flash-attention backward kernel is not ported yet: call under "
            "torch.no_grad()")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    lib = _kernels.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fmh_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B * H, N, M, D, float(scale), stream)
    _kernels.check_launch(code, "flash_attention_fwd")
    _kernels.LAUNCH_COUNTS["flash_attention_fwd"] += 1
    return out, lse


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Dispatching entry point, shapes [B,H,N,D] / [B,H,M,D].

    The flash path serves long unmasked sequences (no mask, N >= 256,
    D <= 128); everything else takes the plain version, as in the reference.
    The inputs are taken to ``device``, which must exist.
    """
    dev = resolve_device(device)
    q, k, v = q.to(dev), k.to(dev), v.to(dev)
    if mask is not None:
        mask = mask.to(dev)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    N, D = q.shape[2], q.shape[3]
    use_flash = mask is None and N >= 256 and D <= 128
    if not use_flash:
        return attention_plain(q, k, v, mask=mask, scale=scale)
    return flash_attention_forward(q, k, v, scale)[0]
