"""Attention: hand-written flash-attention kernels for Hopper, forward and
backward, plus their plain PyTorch versions.

Counterpart of followmyhold_tpu/ops/attention.py. Every attention on the
guided sampler's path (DiT joint attention, ShapeVAE self-attention, the
geo-decoder's cross-attention) goes through ``multi_head_attention``, which
keeps the reference's gate: the flash path serves unmasked sequences of at
least 256 queries with a head size up to 128, the plain version the rest.

The flash path is differentiable, as the reference's custom VJP is: the
forward kernel (csrc/flash_attention_fwd.cu) emits the per-row logsumexp, and
the backward kernel (csrc/flash_attention_bwd.cu) recomputes the probabilities
from it, so no [N, M] matrix is ever stored. On CUDA tensors both launch their
kernels or raise; on CPU tensors both take their plain versions.

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


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernels do not take: they take bf16 [B,H,N,D] /
    [B,H,M,D] on one device with D in {64, 128}; N and M may be ragged."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected [B,H,N,D] and [B,H,M,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, N, D = q.shape
    M = k.shape[2]
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D or M < 1 or N < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    if D not in _KERNEL_HEAD_SIZES:
        raise NotImplementedError(
            f"flash-attention kernels are built for head sizes {_KERNEL_HEAD_SIZES}, got {D}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise NotImplementedError(
            f"flash-attention kernels take bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, logsumexp) of unmasked attention; the bare kernel, not recorded
    by autograd (``multi_head_attention`` is the differentiable entry).

    CUDA tensors launch the kernel or raise; CPU tensors take the plain
    version. Non-contiguous inputs are copied first.
    """
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale)
    _check_kernel_inputs(q, k, v)
    B, H, N, D = q.shape
    M = k.shape[2]
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


def flash_attention_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, dsum: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: (dq f32, dk, dv in k's and v's
    types). ``lse`` is the forward's logsumexp and ``dsum = rowsum(do * o)``,
    both f32 [B,H,N]. The probabilities are rounded to the storage type before
    the dv product and ds before the dk and dq products, as the kernel does."""
    s = _logits(q, k, scale)
    p = torch.exp(s - lse[..., None])
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - dsum[..., None])
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()) * scale
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, dsum: torch.Tensor, scale: float, need_dq: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """(dq f32 or None, dk, dv) of unmasked attention from the forward's
    logsumexp and ``dsum = rowsum(do * o)``.

    CUDA tensors launch the kernel or raise; CPU tensors take the plain
    version. Without ``need_dq`` the kernel skips its dq pass. Non-contiguous
    inputs are copied first.
    """
    if not q.is_cuda:
        dq, dk, dv = flash_attention_backward_plain(q, k, v, do, lse, dsum, scale)
        return (dq if need_dq else None), dk, dv
    _check_kernel_inputs(q, k, v)
    B, H, N, D = q.shape
    M = k.shape[2]
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, x in (("lse", lse), ("dsum", dsum)):
        if x.shape != (B, H, N) or x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(f"{name} must be float32 [B,H,N] on q's device, got "
                             f"{tuple(x.shape)} {x.dtype}")
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    lse, dsum = lse.contiguous(), dsum.contiguous()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device) if need_dq else None
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernels.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fmh_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dsum.data_ptr(), None if dq is None else dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B * H, N, M, D, float(scale), stream)
    _kernels.check_launch(code, "flash_attention_bwd")
    _kernels.LAUNCH_COUNTS["flash_attention_bwd"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The flash path under autograd: the forward kernel, whose logsumexp is
    saved, and the backward kernel. The counterpart of the reference's
    ``_flash_mha`` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dsum = (do.float() * out.float()).sum(dim=-1)   # rowsum(do * o), f32
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        dq, dk, dv = flash_attention_backward(q, k, v, do.to(q.dtype), lse, dsum, ctx.scale,
                                              need_dq=need_q)
        return (dq.to(q.dtype) if need_q else None, dk if need_k else None,
                dv if need_v else None, None)


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
    Under autograd the flash path differentiates through the backward kernel.
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale)
    return flash_attention_forward(q, k, v, scale)[0]
