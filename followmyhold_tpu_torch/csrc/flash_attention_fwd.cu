// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 statistics.
//
// Replaces the TPU kernel `_flash_kernel` launched by `_flash_attention_pallas`
// in followmyhold_tpu/ops/attention.py: O = softmax(Q K^T * scale) V with an
// online softmax over kv tiles, products in bf16 with f32 accumulation, the
// ragged kv tail masked inside the kernel, and the per-row logsumexp emitted
// beside O (the flash backward needs it).
//
// What bounds it on this card: operations. At the main-path shapes the
// 4*B*H*N*M*D flops outweigh the Q, K, V, O bytes by more than the card's
// ~295 flop/byte ridge, so the floor is the bf16 tensor-core rate.
//
// What the design does about it. The TPU version held the whole kv set of a
// head in fast memory (up to 3072 x 64 for K and for V); that is 768 KB and a
// block here has 227 KB, so kv streams through shared memory in tiles of 64
// rows. One block owns 64 query rows of one (batch, head): 4 warps x 16 rows,
// Q fragments stay in registers for the whole sweep, S = Q K^T and O += P V run
// on the tensor cores through mma.sync.m16n8k16, and the softmax runs on the
// accumulator registers (each row of S lives in the 4 threads of a quad, so a
// row maximum or sum is two shuffles). The S accumulator layout of two
// adjacent 8-column tiles is exactly the A-operand layout of the next product,
// so P never touches shared memory. Shared rows are padded by 16 bytes, which
// makes both the K operand reads and the ldmatrix of V conflict-free. Ragged N
// and M are masked here; the host never pads. Tiles are loaded with plain
// 16-byte loads and several blocks per SM hide that latency; wgmma, TMA and an
// asynchronous pipeline are the next step towards the floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;    // query rows per block
constexpr int kBlockN = 64;    // kv rows per tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kPad = 8;        // bf16 elements of row padding in shared memory
constexpr float kNegBig = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two transposed 8x8 bf16 matrices: lanes 0-7 give the row addresses of the
// first, lanes 8-15 of the second. Thread `lane` receives, from each matrix m,
// the pair m[(lane%4)*2 + {0,1}][lane/4]: the B operand of a row-major V.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                 const __nv_bfloat16* __restrict__ V, __nv_bfloat16* __restrict__ O,
                 float* __restrict__ LSE, int N, int M, float scale) {
  constexpr int kRow = D + kPad;
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockN * kRow];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockN * kRow];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  Q += static_cast<size_t>(bh) * N * D;
  K += static_cast<size_t>(bh) * M * D;
  V += static_cast<size_t>(bh) * M * D;
  O += static_cast<size_t>(bh) * N * D;
  LSE += static_cast<size_t>(bh) * N;

  // the two query rows this thread holds; rows past N read row N-1 and are
  // never stored
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const __nv_bfloat16* q_row0 = Q + static_cast<size_t>(min(row0, N - 1)) * D;
  const __nv_bfloat16* q_row1 = Q + static_cast<size_t>(min(row1, N - 1)) * D;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(q_row0 + ks * 16 + t * 2);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(q_row1 + ks * 16 + t * 2);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(q_row0 + ks * 16 + 8 + t * 2);
    qf[ks][3] = *reinterpret_cast<const uint32_t*>(q_row1 + ks * 16 + 8 + t * 2);
  }

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  }
  float m0 = kNegBig, m1 = kNegBig;  // running row maxima of the raw scores
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
  const float sl2 = scale * kLog2e;

  for (int kv0 = 0; kv0 < M; kv0 += kBlockN) {
    __syncthreads();  // the previous tile has been consumed
    constexpr int kChunks = D / 8;  // 16-byte chunks per row
    for (int i = tid; i < kBlockN * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;  // rows past M are zero
      if (kv0 + r < M) {
        const size_t off = static_cast<size_t>(kv0 + r) * D + c * 8;
        kk = *reinterpret_cast<const uint4*>(K + off);
        vv = *reinterpret_cast<const uint4*>(V + off);
      }
      *reinterpret_cast<uint4*>(&sK[r * kRow + c * 8]) = kk;
      *reinterpret_cast<uint4*>(&sV[r * kRow + c * 8]) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows against the tile's 64 columns
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const __nv_bfloat16* kp = &sK[(nt * 8 + g) * kRow + ks * 16 + t * 2];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
        mma_m16n8k16(s[nt], qf[ks], b0, b1);
      }
    }

    if (kv0 + kBlockN > M) {  // ragged tail: columns past M never win
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const int col = kv0 + nt * 8 + t * 2;
        if (col >= M) { s[nt][0] = kNegBig; s[nt][2] = kNegBig; }
        if (col + 1 >= M) { s[nt][1] = kNegBig; s[nt][3] = kNegBig; }
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

    const float alpha0 = exp2f((m0 - mx0) * sl2);
    const float alpha1 = exp2f((m1 - mx1) * sl2);
    m0 = mx0;
    m1 = mx1;
    const float off0 = mx0 * sl2, off1 = mx1 * sl2;

    // P = exp(S*scale - max): f32 for the row sums, bf16 for the product
    uint32_t pf[kBlockN / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      const float p0 = exp2f(s[nt][0] * sl2 - off0);
      const float p1 = exp2f(s[nt][1] * sl2 - off0);
      const float p2 = exp2f(s[nt][2] * sl2 - off1);
      const float p3 = exp2f(s[nt][3] * sl2 - off1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;

#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= alpha0;
      o[dt][1] *= alpha0;
      o[dt][2] *= alpha1;
      o[dt][3] *= alpha1;
    }
    // O += P V
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &sV[(kk * 16 + (lane & 15)) * kRow + dt * 8]);
        mma_m16n8k16(o[dt], pf[kk], b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  if (row0 < N) {
    __nv_bfloat16* orow = O + static_cast<size_t>(row0) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + t * 2) =
          pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    }
    if (t == 0) LSE[row0] = m0 * scale + logf(l0);
  }
  if (row1 < N) {
    __nv_bfloat16* orow = O + static_cast<size_t>(row1) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + t * 2) =
          pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
    }
    if (t == 0) LSE[row1] = m1 * scale + logf(l1);
  }
}

}  // namespace

// q [BH,N,D], k and v [BH,M,D], o [BH,N,D] bf16 contiguous; lse [BH,N] f32.
// Returns cudaGetLastError() after the launch, or -1 for a head size the
// kernel is not instantiated for.
extern "C" int fmh_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int BH, int N, int M, int D, float scale,
                                       void* stream) {
  const dim3 grid((N + kBlockM - 1) / kBlockM, BH);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  if (D == 64) {
    flash_fwd_kernel<64><<<grid, block, 0, st>>>(qp, kp, vp, op, lp, N, M, scale);
  } else if (D == 128) {
    flash_fwd_kernel<128><<<grid, block, 0, st>>>(qp, kp, vp, op, lp, N, M, scale);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
