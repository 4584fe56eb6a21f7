"""The attention prologue of the FLUX blocks: the per-head RMS-norm of q and k
(diffusers' ``qk_norm='rms_norm'``), the rotary embedding on their interleaved
(even, odd) pairs, and the placement of q, k and v in the joint ``[B, H, N, D]``
sequence that the flash-attention forward reads.

A block hands ``qk_norm_rope`` its streams in joint order, each as its three
projections ``[B, n, H * D]`` and its two norm scales: a double block its text
stream then its image stream, a single block its one stream. On CUDA,
csrc/qk_norm_rope.cu writes each stream's rows at its offset in three joint
buffers, one launch a stream, so nothing is concatenated and the attention
finds q, k and v contiguous; it takes bf16 projections with FLUX.1's head size
of 128 and raises for others. Tensors off the card take ``qk_norm_rope_plain``:
the norm, the concatenation and the rotation as separate PyTorch operations,
the yardstick the kernel is held to.

Precision: the norm in float32, rounded to the activations' type; the rotation
in float32 from that value, rounded again.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from followmyhold_tpu_torch.ops import _kernels

QK_NORM_EPS = 1e-6
_KERNEL_HEAD_SIZE = 128   # FLUX.1's

# one stream of a block: its q, k and v projections [B, n, H * D] and the norm
# scales of q and k, float32 [D]
Stream = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def rms_norm_heads(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """RMS-norm over the last dimension with a learned scale, in float32, cast
    back to ``x``'s type."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + QK_NORM_EPS) * weight).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, N, D]: rotate its interleaved (even, odd) pairs, in float32."""
    xr = x.float().reshape(*x.shape[:-1], -1, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    c, s = cos[None, None], sin[None, None]
    out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, n, H * D] -> the view [B, H, n, D]."""
    B, n, width = x.shape
    return x.reshape(B, n, heads, width // heads).permute(0, 2, 1, 3)


def qk_norm_rope_plain(streams: Sequence[Stream], cos: torch.Tensor, sin: torch.Tensor,
                       heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: each stream's q and k normed, the streams joined along
    the sequence, q and k rotated. Returns q, k, v [B, H, N_joint, D]; a single
    stream's v is the view of its projection."""
    qs, ks, vs = [], [], []
    for q, k, v, q_weight, k_weight in streams:
        qs.append(rms_norm_heads(_heads(q, heads), q_weight))
        ks.append(rms_norm_heads(_heads(k, heads), k_weight))
        vs.append(_heads(v, heads))

    def joined(xs):
        return xs[0] if len(xs) == 1 else torch.cat(xs, dim=2)

    return apply_rope(joined(qs), cos, sin), apply_rope(joined(ks), cos, sin), joined(vs)


def _row_strides(x: torch.Tensor) -> Tuple[int, int]:
    """The row and batch strides of x [B, n, width]; 0 where that axis has one
    entry, so its stride is never used."""
    B, n, _ = x.shape
    return (x.stride(1) if n > 1 else 0, x.stride(0) if B > 1 else 0)


def qk_norm_rope_into(stream: Stream, cos: torch.Tensor, sin: torch.Tensor, heads: int,
                      out: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                      offset: int) -> None:
    """Launch the kernel for one stream: its rows, normed and rotated, into
    rows [offset, offset + n) of ``out`` = (q, k, v) bf16 [B, H, N_joint, D],
    contiguous; the rotation of joint row j takes row j of ``cos`` and ``sin``
    (float32 [N_joint, D // 2]). Not recorded by autograd."""
    q, k, v, q_weight, k_weight = stream
    q_out, k_out, v_out = out
    B, H, n_joint, D = q_out.shape
    n = q.shape[1]
    if H != heads or D != _KERNEL_HEAD_SIZE:
        raise NotImplementedError(f"the qk_norm_rope kernel is built for heads of "
                                  f"{_KERNEL_HEAD_SIZE}, got {heads} heads of {D}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.shape != (B, n, H * D) or x.dtype != torch.bfloat16 or x.device != q_out.device:
            raise ValueError(f"{name} must be bf16 [{B}, {n}, {H * D}] on {q_out.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    for name, x in (("q_out", q_out), ("k_out", k_out), ("v_out", v_out)):
        if (x.shape != (B, H, n_joint, D) or x.dtype != torch.bfloat16
                or x.device != q_out.device or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous, 16-byte aligned bf16 "
                             f"{(B, H, n_joint, D)}, got {tuple(x.shape)} {x.dtype}")
    if not 0 <= offset <= n_joint - n:
        raise ValueError(f"rows [{offset}, {offset + n}) do not lie in {n_joint}")
    strides = _row_strides(q)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if (x.stride(2) != 1 or x.data_ptr() % 16 or _row_strides(x) != strides
                or any(s % 8 for s in strides)):
            raise ValueError(f"q, k and v must have contiguous columns, the same row and batch "
                             f"strides in multiples of 8 and 16-byte aligned rows; {name} has "
                             f"strides {x.stride()} at {x.data_ptr() % 16} bytes past 16, q "
                             f"{q.stride()}")
    for name, x, shape in (("q_weight", q_weight, (D,)), ("k_weight", k_weight, (D,)),
                           ("cos", cos, (n_joint, D // 2)), ("sin", sin, (n_joint, D // 2))):
        if (x.shape != shape or x.dtype != torch.float32 or x.device != q_out.device
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous, 16-byte aligned float32 {shape} on "
                             f"{q_out.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    row_stride, batch_stride = strides
    lib = _kernels.load_library()
    with torch.cuda.device(q_out.device):
        code = lib.fmh_qk_norm_rope(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_weight.data_ptr(), k_weight.data_ptr(),
            cos.data_ptr(), sin.data_ptr(), q_out.data_ptr(), k_out.data_ptr(),
            v_out.data_ptr(), B, n, H, D, row_stride, batch_stride, n_joint, offset,
            QK_NORM_EPS, torch.cuda.current_stream().cuda_stream)
    _kernels.check_launch(code, "qk_norm_rope")
    _kernels.LAUNCH_COUNTS["qk_norm_rope"] += 1


def qk_norm_rope_forward(streams: Sequence[Stream], cos: torch.Tensor, sin: torch.Tensor,
                         heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel path: one launch a stream into three joint buffers."""
    q = streams[0][0]
    B, width = q.shape[0], q.shape[2]
    n_joint = sum(s[0].shape[1] for s in streams)
    out = tuple(torch.empty((B, heads, n_joint, width // heads), dtype=torch.bfloat16,
                            device=q.device) for _ in range(3))
    offset = 0
    for stream in streams:
        qk_norm_rope_into(stream, cos, sin, heads, out, offset)
        offset += stream[0].shape[1]
    return out


def qk_norm_rope(streams: Sequence[Stream], cos: torch.Tensor, sin: torch.Tensor,
                 heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v [B, H, N_joint, D] for the joint attention over ``streams``
    (each (q, k, v, q_norm_scale, k_norm_scale), in joint order): q and k
    RMS-normed per head and rotated by ``cos`` / ``sin`` [N_joint, D // 2].
    On CUDA the kernel, which raises for other types than bf16 and other head
    sizes than 128, and where a gradient is wanted (it has no backward);
    elsewhere the plain version."""
    if streams[0][0].device.type != "cuda":
        return qk_norm_rope_plain(streams, cos, sin, heads)
    if torch.is_grad_enabled() and any(x.requires_grad for s in streams for x in s):
        raise NotImplementedError("the qk_norm_rope kernel has no backward")
    return qk_norm_rope_forward(streams, cos, sin, heads)
