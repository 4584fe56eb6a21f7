// The attention prologue of the FLUX blocks for Hopper (sm_90a): the per-head
// RMS-norm of q and k, the rotary embedding on their interleaved (even, odd)
// pairs, and the placement of q, k and v in the joint [B, H, N_joint, D]
// sequence that the flash-attention forward (flash_attention_fwd.cu) reads.
//
// No Pallas kernel of the JAX package stands behind it: there, XLA fuses
// followmyhold_tpu/models/flux.py's QKNorm, apply_rope and the concatenation
// of the text and image streams into the attention's operands. In PyTorch the
// same lines (ops/rope.qk_norm_rope_plain) are some 35-53 launches a block
// over float32 copies of every activation, ~1.5 GB of device traffic a block
// at FLUX.1's [1, 2560, 3072].
//
// What bounds it on this card: bytes. Each element of q, k and v is read once
// (bf16) and written once (bf16) with a few float32 operations between; the
// norm scales and the cos/sin rows are shared by every head and stay in cache.
//
// What the design does about it.
// - A thread takes 8 columns (16 bytes) of one token's q, k and v: three
//   16-byte loads in flight at once, three 16-byte stores. 16 neighbouring
//   threads hold one head's row of 128; its sum of squares is folded by
//   shuffles within that half-warp, in float32.
// - A block is 128 threads: 1,024 columns of one token. The grid is (tokens,
//   column groups), so every SM has many small blocks and the loads of many
//   rows in flight.
// - Each (even, odd) pair stays in one thread, so the rotation needs no
//   exchange; its 4 pairs' cos and sin are two 16-byte loads of the token's
//   row of the joint table.
// - One launch writes one stream's rows at `offset` in the joint sequence, so
//   a double block's text and image streams meet in one buffer without a
//   concatenation.
//
// Rounding follows the plain path, so the two can be held element by element:
// the square, the sum, the mean, the rsqrt, the two products of the norm, the
// rotation's products and its sum or difference are each one float32 operation
// rounded to nearest (the __f*_rn intrinsics keep the compiler from fusing
// them into FMAs the plain path does not have); the norm's result is rounded to
// bf16, as QKNorm returns it, and the rotation starts from that bf16 value. The
// sum of squares adds in another order than PyTorch's reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kHeadDim = 128;  // FLUX.1's head size, the only one built
constexpr int kThreads = 128;
constexpr int kVec = 8;  // bf16 columns a thread: 16 bytes
constexpr int kGroup = kHeadDim / kVec;  // threads of one head row: half a warp
constexpr int kBlockCols = kThreads * kVec;
static_assert(kBlockCols % kHeadDim == 0, "a block holds whole heads");

__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[kVec]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // bf16 -> f32 is exact: the 16 bits become the high half
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One head row's 8 columns: RMS-norm with `weight`, rounded to bf16, then the
// rotation of its 4 pairs, rounded to bf16 again.
__device__ __forceinline__ uint4 norm_rope(const uint4& raw, const float* __restrict__ weight,
                                           const float4& cs, const float4& sn, int d,
                                           unsigned group_mask, float eps) {
  float x[kVec];
  unpack(raw, x);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) ss = __fadd_rn(ss, __fmul_rn(x[j], x[j]));
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(group_mask, ss, off));
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / kHeadDim), eps));
  const float4 w0 = *reinterpret_cast<const float4*>(weight + d);
  const float4 w1 = *reinterpret_cast<const float4*>(weight + d + 4);
  const float w[kVec] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const float c[4] = {cs.x, cs.y, cs.z, cs.w};
  const float s[4] = {sn.x, sn.y, sn.z, sn.w};
  uint32_t out[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float y0 = bf16_round(__fmul_rn(__fmul_rn(x[2 * p], r), w[2 * p]));
    const float y1 = bf16_round(__fmul_rn(__fmul_rn(x[2 * p + 1], r), w[2 * p + 1]));
    const float o0 = __fsub_rn(__fmul_rn(y0, c[p]), __fmul_rn(y1, s[p]));
    const float o1 = __fadd_rn(__fmul_rn(y0, s[p]), __fmul_rn(y1, c[p]));
    out[p] = pack2(o0, o1);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

__global__ void __launch_bounds__(kThreads)
qk_norm_rope_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const float* __restrict__ q_weight,
                    const float* __restrict__ k_weight, const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ q_out,
                    __nv_bfloat16* __restrict__ k_out, __nv_bfloat16* __restrict__ v_out, int n,
                    int heads, long long row_stride, long long batch_stride, int n_joint,
                    int offset, float eps) {
  const int token = blockIdx.x;  // b * n + i
  const int col = (blockIdx.y * kThreads + threadIdx.x) * kVec;
  // columns come in whole heads, a block's too, so a head row's group is all
  // in or all out
  if (col >= heads * kHeadDim) return;
  const unsigned group_mask = 0xffffu << (threadIdx.x & 16);  // this half-warp
  const int b = token / n;
  const int i = token - b * n;
  const int h = col / kHeadDim;
  const int d = col - h * kHeadDim;
  const long long src = b * batch_stride + i * row_stride + col;
  const long long dst =
      ((static_cast<long long>(b) * heads + h) * n_joint + offset + i) * kHeadDim + d;
  const uint4 rq = __ldg(reinterpret_cast<const uint4*>(q + src));
  const uint4 rk = __ldg(reinterpret_cast<const uint4*>(k + src));
  const uint4 rv = __ldg(reinterpret_cast<const uint4*>(v + src));
  const long long rope = static_cast<long long>(offset + i) * (kHeadDim / 2) + d / 2;
  const float4 cs = __ldg(reinterpret_cast<const float4*>(cos_t + rope));
  const float4 sn = __ldg(reinterpret_cast<const float4*>(sin_t + rope));
  *reinterpret_cast<uint4*>(v_out + dst) = rv;
  *reinterpret_cast<uint4*>(q_out + dst) =
      norm_rope(rq, q_weight, cs, sn, d, group_mask, eps);
  *reinterpret_cast<uint4*>(k_out + dst) =
      norm_rope(rk, k_weight, cs, sn, d, group_mask, eps);
}

}  // namespace

// One stream of a block: q, k, v bf16 [batch, n, heads * 128], rows
// `row_stride` and batches `batch_stride` elements apart (multiples of 8; the
// columns contiguous; 16-byte aligned); q_weight, k_weight f32 [128]; cos_t,
// sin_t f32 [n_joint, 64], contiguous. Writes rows [offset, offset + n) of
// q_out, k_out, v_out bf16 [batch, heads, n_joint, 128], contiguous; the
// rotation of row offset + i takes row offset + i of cos_t and sin_t. Returns
// cudaGetLastError() after the launch.
extern "C" int fmh_qk_norm_rope(const void* q, const void* k, const void* v,
                                const void* q_weight, const void* k_weight, const void* cos_t,
                                const void* sin_t, void* q_out, void* k_out, void* v_out,
                                int batch, int n, int heads, int head_dim, int row_stride,
                                int batch_stride, int n_joint, int offset, float eps,
                                void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || head_dim != kHeadDim || offset < 0 ||
      offset + n > n_joint || row_stride % kVec != 0 || batch_stride % kVec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(batch * n, (heads * kHeadDim + kBlockCols - 1) / kBlockCols);
  qk_norm_rope_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(q_weight),
      static_cast<const float*>(k_weight), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(q_out),
      static_cast<__nv_bfloat16*>(k_out), static_cast<__nv_bfloat16*>(v_out), n, heads,
      row_stride, batch_stride, n_joint, offset, eps);
  return static_cast<int>(cudaGetLastError());
}
