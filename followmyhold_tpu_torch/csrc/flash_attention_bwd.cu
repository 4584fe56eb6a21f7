// Flash-attention backward for Hopper (sm_90a): dq, dk, dv from q, k, v, do,
// the forward's logsumexp and dsum = rowsum(do * o); bf16 in, f32 statistics.
//
// Replaces the TPU kernel `_flash_bwd_fused_kernel` launched by
// `_flash_backward_pallas` in followmyhold_tpu/ops/attention.py. Per (query
// row, kv column) it recomputes p = exp(s*scale - lse) from the forward's
// logsumexp and applies
//     dv += p^T do           (p rounded to bf16 first, as the TPU kernel does)
//     dp  = do v^T
//     ds  = p * (dp - dsum)
//     dk += ds^T q * scale   (ds rounded to bf16)
//     dq += ds k * scale     (ds rounded to bf16, dq kept in f32)
// with every product on the tensor cores through mma.sync.m16n8k16 (bf16 in,
// f32 accumulators).
//
// What bounds it on this card: operations. Five products of 2*N*M*D flops
// each per (batch, head) outweigh the bytes of q, k, v, do, o and the three
// gradients by far more than the card's ~295 flop/byte ridge at the main-path
// shapes, so the floor is the bf16 tensor-core rate.
//
// What Hopper lacks, and what the design does about it. The TPU kernel walked
// the kv blocks in order on one core and kept the f32 dq block of a whole head
// resident in fast memory across that sweep. Blocks here run in any order and
// share nothing, so the backward is two passes from one source, both without
// atomics and deterministic:
//   - the dk/dv pass runs one block per (batch*head, 64 kv rows) and loops over
//     query tiles; each warp owns 16 kv rows, so S^T = K Q^T and dP^T = V dO^T
//     come out with kv rows in the accumulators and feed dv += P^T dO and
//     dk += dS^T Q without a transpose through shared memory;
//   - the dq pass runs one block per (batch*head, 64 query rows) and loops over
//     kv tiles, recomputing S, P, dP and dS (two of the five products twice),
//     and is skipped when the caller needs no dq (the geo-decoder's queries
//     come from grid points through frozen weights).
// The accumulators of S / dP of two adjacent 8-column tiles are exactly the A
// operand of the next product, so P and dS never touch shared memory. The B
// operands of the products over the kv or query axis come from ldmatrix.trans.
// K1's fragment layouts and 16-byte row padding (conflict-free operand reads)
// are reused. Ragged N and M are masked here: kv columns past M get p = 0
// (they would feed dq), query rows past N get p = 0 (they must add nothing to
// dk and dv), and rows past the ends are never stored. Tiles are loaded with
// plain 16-byte loads; TMA, wgmma and an asynchronous pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // rows a block owns (kv rows or query rows)
constexpr int kTileN = 64;     // kv rows per tile of the dq pass
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kPad = 8;        // bf16 elements of row padding in shared memory
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
// the pair m[(lane%4)*2 + {0,1}][lane/4]: the B operand of a product over the
// rows of a row-major tile.
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + n_rows) of a [len, D] matrix into shared memory with padded
// rows; rows at or past len are zero
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int r0, int n_rows, int len) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kRow = D + kPad;
  for (int i = threadIdx.x; i < n_rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < len) {
      x = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(&dst[r * kRow + c * 8]) = x;
  }
}

// acc[nt] += A_rows(16 of sA from row `a_row`) . B_rows(nt*8.. of sB)^T over D:
// the A operand is read row-major from sA, the B operand row-major from sB
template <int D, int NT>
__device__ __forceinline__ void product_rows_by_rows(float (&acc)[NT][4],
                                                     const __nv_bfloat16* sA, int a_row,
                                                     const __nv_bfloat16* sB, int g, int t) {
  constexpr int kRow = D + kPad;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const __nv_bfloat16* ap = &sA[(a_row + g) * kRow + ks * 16 + t * 2];
    const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * kRow), ld32(ap + 8),
                           ld32(ap + 8 * kRow + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* bp = &sB[(nt * 8 + g) * kRow + ks * 16 + t * 2];
      mma_m16n8k16(acc[nt], a, ld32(bp), ld32(bp + 8));
    }
  }
}

// acc[dt] += F . sB over the F's columns, F given as bf16 A fragments of KT
// 16-column tiles, sB a row-major [16*KT, D] tile read transposed
template <int D, int KT>
__device__ __forceinline__ void product_frags_by_tile(float (&acc)[D / 8][4],
                                                      const uint32_t (&f)[KT][4],
                                                      const __nv_bfloat16* sB, int lane) {
  constexpr int kRow = D + kPad;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, &sB[(kk * 16 + (lane & 15)) * kRow + dt * 8]);
      mma_m16n8k16(acc[dt], f[kk], b0, b1);
    }
  }
}

// dk/dv pass: one block per (bh, 64 kv rows), a loop over query tiles of BQ
template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                      const __nv_bfloat16* __restrict__ V, const __nv_bfloat16* __restrict__ dO,
                      const float* __restrict__ LSE, const float* __restrict__ DSUM,
                      __nv_bfloat16* __restrict__ dK, __nv_bfloat16* __restrict__ dV,
                      int N, int M, float scale) {
  constexpr int kRow = D + kPad;
  constexpr int NT = BQ / 8;   // 8-column accumulator tiles per query tile
  constexpr int KT = BQ / 16;  // 16-column operand tiles per query tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kRows * kRow;
  __nv_bfloat16* sQ = sV + kRows * kRow;
  __nv_bfloat16* sdO = sQ + BQ * kRow;
  float* sL = reinterpret_cast<float*>(sdO + BQ * kRow);
  float* sDs = sL + BQ;

  const int bh = blockIdx.y;
  const int kv0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;

  Q += static_cast<size_t>(bh) * N * D;
  dO += static_cast<size_t>(bh) * N * D;
  K += static_cast<size_t>(bh) * M * D;
  V += static_cast<size_t>(bh) * M * D;
  dK += static_cast<size_t>(bh) * M * D;
  dV += static_cast<size_t>(bh) * M * D;
  LSE += static_cast<size_t>(bh) * N;
  DSUM += static_cast<size_t>(bh) * N;

  load_tile<D>(sK, K, kv0, kRows, M);
  load_tile<D>(sV, V, kv0, kRows, M);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }
  const float sl2 = scale * kLog2e;

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();  // the previous query tile has been consumed
    load_tile<D>(sQ, Q, q0, BQ, N);
    load_tile<D>(sdO, dO, q0, BQ, N);
    for (int i = tid; i < BQ; i += kThreads) {
      const bool in = q0 + i < N;
      sL[i] = in ? LSE[q0 + i] * kLog2e : 0.f;
      sDs[i] = in ? DSUM[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 kv rows
    float st[NT][4], dpt[NT][4];
    product_rows_by_rows<D, NT>(st, sK, wr, sQ, g, t);
    product_rows_by_rows<D, NT>(dpt, sV, wr, sdO, g, t);

    // P^T, dS^T; columns are query rows, rows past N contribute nothing
    uint32_t pf[KT][4], dsf[KT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1);
        p[e] = (q0 + col < N) ? exp2f(st[nt][e] * sl2 - sL[col]) : 0.f;
        ds[e] = p[e] * (dpt[nt][e] - sDs[col]);
      }
      pf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO, dK += dS^T Q (products over the tile's query rows)
    product_frags_by_tile<D, KT>(dv, pf, sdO, lane);
    product_frags_by_tile<D, KT>(dk, dsf, sQ, lane);
  }

  const int r0 = kv0 + wr + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (r0 < M) {
      *reinterpret_cast<uint32_t*>(dK + static_cast<size_t>(r0) * D + c) =
          pack_bf16(dk[dt][0] * scale, dk[dt][1] * scale);
      *reinterpret_cast<uint32_t*>(dV + static_cast<size_t>(r0) * D + c) =
          pack_bf16(dv[dt][0], dv[dt][1]);
    }
    if (r1 < M) {
      *reinterpret_cast<uint32_t*>(dK + static_cast<size_t>(r1) * D + c) =
          pack_bf16(dk[dt][2] * scale, dk[dt][3] * scale);
      *reinterpret_cast<uint32_t*>(dV + static_cast<size_t>(r1) * D + c) =
          pack_bf16(dv[dt][2], dv[dt][3]);
    }
  }
}

// dq pass: one block per (bh, 64 query rows), a loop over kv tiles of 64
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                    const __nv_bfloat16* __restrict__ V, const __nv_bfloat16* __restrict__ dO,
                    const float* __restrict__ LSE, const float* __restrict__ DSUM,
                    float* __restrict__ dQ, int N, int M, float scale) {
  constexpr int kRow = D + kPad;
  constexpr int NT = kTileN / 8;
  constexpr int KT = kTileN / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + kRows * kRow;
  __nv_bfloat16* sK = sdO + kRows * kRow;
  __nv_bfloat16* sV = sK + kTileN * kRow;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;

  Q += static_cast<size_t>(bh) * N * D;
  dO += static_cast<size_t>(bh) * N * D;
  dQ += static_cast<size_t>(bh) * N * D;
  K += static_cast<size_t>(bh) * M * D;
  V += static_cast<size_t>(bh) * M * D;
  LSE += static_cast<size_t>(bh) * N;
  DSUM += static_cast<size_t>(bh) * N;

  load_tile<D>(sQ, Q, q0, kRows, N);
  load_tile<D>(sdO, dO, q0, kRows, N);

  // the two query rows this thread holds; rows past N are never stored
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const float l0 = row0 < N ? LSE[row0] * kLog2e : 0.f;
  const float l1 = row1 < N ? LSE[row1] * kLog2e : 0.f;
  const float ds0 = row0 < N ? DSUM[row0] : 0.f;
  const float ds1 = row1 < N ? DSUM[row1] : 0.f;
  const float sl2 = scale * kLog2e;

  float dq[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
  }

  for (int kv0 = 0; kv0 < M; kv0 += kTileN) {
    __syncthreads();  // the previous kv tile has been consumed
    load_tile<D>(sK, K, kv0, kTileN, M);
    load_tile<D>(sV, V, kv0, kTileN, M);
    __syncthreads();

    float s[NT][4], dp[NT][4];
    product_rows_by_rows<D, NT>(s, sQ, wr, sK, g, t);
    product_rows_by_rows<D, NT>(dp, sdO, wr, sV, g, t);

    // dS = P (dP - dsum); kv columns past M are zero (they would feed dq)
    uint32_t dsf[KT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nt * 8 + t * 2 + (e & 1);
        const float l = (e < 2) ? l0 : l1;
        const float dsum = (e < 2) ? ds0 : ds1;
        const float p = (col < M) ? exp2f(s[nt][e] * sl2 - l) : 0.f;
        ds[e] = p * (dp[nt][e] - dsum);
      }
      dsf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K (a product over the tile's kv rows)
    product_frags_by_tile<D, KT>(dq, dsf, sK, lane);
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (row0 < N) {
      *reinterpret_cast<float2*>(dQ + static_cast<size_t>(row0) * D + c) =
          make_float2(dq[dt][0] * scale, dq[dt][1] * scale);
    }
    if (row1 < N) {
      *reinterpret_cast<float2*>(dQ + static_cast<size_t>(row1) * D + c) =
          make_float2(dq[dt][2] * scale, dq[dt][3] * scale);
    }
  }
}

template <int D>
constexpr int dkdv_block_q() {
  return D == 128 ? 32 : 64;  // keeps the D=128 accumulators within the registers
}

template <int D>
size_t dkdv_smem_bytes() {
  constexpr int BQ = dkdv_block_q<D>();
  return sizeof(__nv_bfloat16) * (2 * kRows + 2 * BQ) * (D + kPad) + sizeof(float) * 2 * BQ;
}

template <int D>
size_t dq_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * kRows + 2 * kTileN) * (D + kPad);
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const __nv_bfloat16* dout, const float* lse, const float* dsum, float* dq,
           __nv_bfloat16* dk, __nv_bfloat16* dv, int BH, int N, int M, float scale,
           cudaStream_t st) {
  constexpr int BQ = dkdv_block_q<D>();
  const size_t dkdv_smem = dkdv_smem_bytes<D>();
  const size_t dq_smem = dq_smem_bytes<D>();
  // both above the 48 KB a launch gets without asking at D=128
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dkdv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dk != nullptr) {
    const dim3 grid((M + kRows - 1) / kRows, BH);
    flash_bwd_dkdv_kernel<D, BQ><<<grid, kThreads, dkdv_smem, st>>>(
        q, k, v, dout, lse, dsum, dk, dv, N, M, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dq != nullptr) {
    const dim3 grid((N + kRows - 1) / kRows, BH);
    flash_bwd_dq_kernel<D><<<grid, kThreads, dq_smem, st>>>(
        q, k, v, dout, lse, dsum, dq, N, M, scale);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// q, do [BH,N,D] and k, v [BH,M,D] bf16 contiguous; lse, dsum [BH,N] f32.
// Outputs: dq [BH,N,D] f32, dk and dv [BH,M,D] bf16. A null dq skips the dq
// pass; a null dk skips the dk/dv pass (dv must then be null too).
// Returns the first CUDA error of the launches, or -1 for a head size the
// kernels are not instantiated for.
extern "C" int fmh_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* dsum,
                                       void* dq, void* dk, void* dv, int BH, int N, int M,
                                       int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dsp = static_cast<const float*>(dsum);
  auto* dqp = static_cast<float*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  if (D == 64) {
    return launch<64>(qp, kp, vp, dop, lp, dsp, dqp, dkp, dvp, BH, N, M, scale, st);
  }
  if (D == 128) {
    return launch<128>(qp, kp, vp, dop, lp, dsp, dqp, dkp, dvp, BH, N, M, scale, st);
  }
  return -1;
}
