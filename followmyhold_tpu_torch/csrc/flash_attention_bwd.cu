// Flash-attention backward for Hopper (sm_90a): dq, dk, dv from q, k, v, do,
// the forward's logsumexp and dsum = rowsum(do * o); bf16 in, f32 statistics.
//
// Replaces the TPU kernel `_flash_bwd_fused_kernel` launched by
// `_flash_backward_pallas` in followmyhold_tpu/ops/attention.py. The TPU
// kernel walked a head's kv blocks in order on one core and kept the head's
// f32 dq block resident in fast memory across that sweep. Per (query row, kv
// column) both recompute p = exp(s*scale - lse) from the forward's logsumexp
// and apply
//     dv += p^T do           (p rounded to bf16 first, as the TPU kernel does)
//     dp  = do v^T
//     ds  = p * (dp - dsum)
//     dk += ds^T q * scale   (ds rounded to bf16)
//     dq += ds k * scale     (ds rounded to bf16, dq kept in f32)
//
// What bounds it on this card: operations. Five products of 2*N*M*D flops
// each per (batch, head) outweigh the bytes of q, k, v, do, o and the three
// gradients by far more than the card's ~295 flop/byte ridge at the main-path
// shapes, so the floor is the bf16 tensor-core rate, which only wgmma reaches.
//
// Blocks here run in any order and share nothing, so the backward is two
// passes from one source, both without atomics and deterministic (dq is
// bit-reproducible): a dk/dv pass over kv rows that loops over query tiles,
// and a dq pass over query rows that loops over kv tiles and recomputes S and
// dP (seven products where five are needed). The dq pass is skipped when the
// caller needs no dq (the geo decoder's queries come from grid points through
// frozen weights). Ragged N and M are masked here, never padded on the host:
// kv columns past M get p = 0, query rows past N get p = 0 (they must add
// nothing to dk and dv), and rows past the ends are never stored.
//
// D=64, the head size of the main path (the ShapeVAE's self-attention and
// the geo decoder's cross-attention), takes the Hopper design. The first
// design (kept for D=128, below) loaded every tile synchronously between two
// barriers, ran every product as mma.sync, fed its operands through the math
// warps' own shared-memory loads, and reached 144-165 TFLOP/s. Here:
//   - every product is wgmma.m64n64k16 (bf16, f32 accumulators), issued by
//     one warpgroup for its 64 rows;
//   - the tiles of the streamed side (Q, dO with lse and dsum in the dk/dv
//     pass; K, V in the dq pass) arrive through a ring of four stages, two
//     tiles in flight ahead of the one consumed. cp.async writes each tile
//     straight into the 128-byte swizzled layout that the wgmma descriptors
//     name, so no warp copies operands; one block barrier per tile frees the
//     stage consumed two tiles back;
//   - S^T = K Q^T and dP^T = V dO^T (S and dP in the dq pass) read the
//     streamed tile K-major. P^T and dS^T are converted to bf16 in the f32
//     accumulator registers they came out of, which is the register A-operand
//     layout of dV += P^T dO and dK += dS^T Q (dQ += dS K); their B operand is
//     the same streamed tile read MN-major through the transpose bit, so
//     nothing goes back through shared memory;
//   - the dk/dv pass keeps its block's K and V rows as register A fragments,
//     loaded once, which halves the shared-memory reads of S^T and dP^T (an
//     m64n64k16 with both operands in shared memory reads 4 KB per 32
//     tensor-cycles, the SM's whole 128 B/clk). The dq pass keeps Q and dO in
//     shared memory instead: that holds it to 128 registers and two blocks an
//     SM, which measured faster than the registers' one;
//   - the dP^T product runs while the exponentials of P^T are taken, and the
//     dV product while dS^T is formed (wgmma groups are waited on one at a
//     time);
//   - the arithmetic between the products runs on the CUDA cores beside
//     tensor cores that need ~1000 cycles a tile, and is of the same order,
//     so only the last tile of a ragged length pays for the column mask (it
//     took a sixth of the dk/dv pass's time when every tile did).
// D=128 serves only the DiT (run without gradients on the main path). Its
// dk, dv and P^T, dP^T accumulators of 64 kv rows would take some 190 f32
// registers a thread, so it keeps the first design: mma.sync.m16n8k16 with
// synchronous tile loads, four warps of 16 kv rows (32-query tiles), operands
// through ld32/ldmatrix.trans from padded rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using hopper::pack_bf16;

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------------- //
// D=128: mma.sync with synchronous tile loads (the first design)
// ------------------------------------------------------------------------- //
namespace ms {

constexpr int kD = 128;        // head size
constexpr int kRows = 64;      // rows a block owns (kv rows or query rows)
constexpr int kTileN = 64;     // kv rows per tile of the dq pass
constexpr int kBlockQ = 32;    // query rows per tile of the dk/dv pass: keeps its
                               // accumulators within the registers
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kPad = 8;        // bf16 elements of row padding in shared memory
constexpr int kRow = kD + kPad;

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + n_rows) of a [len, kD] matrix into shared memory with padded
// rows; rows at or past len are zero
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                          int n_rows, int len) {
  constexpr int kChunks = kD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < n_rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < len) {
      x = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * kD + c * 8);
    }
    *reinterpret_cast<uint4*>(&dst[r * kRow + c * 8]) = x;
  }
}

// acc[nt] += A_rows(16 of sA from row `a_row`) . B_rows(nt*8.. of sB)^T over kD:
// the A operand is read row-major from sA, the B operand row-major from sB
template <int NT>
__device__ __forceinline__ void product_rows_by_rows(float (&acc)[NT][4],
                                                     const __nv_bfloat16* sA, int a_row,
                                                     const __nv_bfloat16* sB, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
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
// 16-column tiles, sB a row-major [16*KT, kD] tile read transposed
template <int KT>
__device__ __forceinline__ void product_frags_by_tile(float (&acc)[kD / 8][4],
                                                      const uint32_t (&f)[KT][4],
                                                      const __nv_bfloat16* sB, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, &sB[(kk * 16 + (lane & 15)) * kRow + dt * 8]);
      mma_m16n8k16(acc[dt], f[kk], b0, b1);
    }
  }
}

// dk/dv pass: one block per (bh, 64 kv rows), a loop over query tiles of kBlockQ
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                      const __nv_bfloat16* __restrict__ V, const __nv_bfloat16* __restrict__ dO,
                      const float* __restrict__ LSE, const float* __restrict__ DSUM,
                      __nv_bfloat16* __restrict__ dK, __nv_bfloat16* __restrict__ dV,
                      int N, int M, float scale) {
  constexpr int BQ = kBlockQ;
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

  Q += static_cast<size_t>(bh) * N * kD;
  dO += static_cast<size_t>(bh) * N * kD;
  K += static_cast<size_t>(bh) * M * kD;
  V += static_cast<size_t>(bh) * M * kD;
  dK += static_cast<size_t>(bh) * M * kD;
  dV += static_cast<size_t>(bh) * M * kD;
  LSE += static_cast<size_t>(bh) * N;
  DSUM += static_cast<size_t>(bh) * N;

  load_tile(sK, K, kv0, kRows, M);
  load_tile(sV, V, kv0, kRows, M);

  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }
  const float sl2 = scale * kLog2e;

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();  // the previous query tile has been consumed
    load_tile(sQ, Q, q0, BQ, N);
    load_tile(sdO, dO, q0, BQ, N);
    for (int i = tid; i < BQ; i += kThreads) {
      const bool in = q0 + i < N;
      sL[i] = in ? LSE[q0 + i] * kLog2e : 0.f;
      sDs[i] = in ? DSUM[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 kv rows
    float st[NT][4], dpt[NT][4];
    product_rows_by_rows<NT>(st, sK, wr, sQ, g, t);
    product_rows_by_rows<NT>(dpt, sV, wr, sdO, g, t);

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
    product_frags_by_tile<KT>(dv, pf, sdO, lane);
    product_frags_by_tile<KT>(dk, dsf, sQ, lane);
  }

  const int r0 = kv0 + wr + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (r0 < M) {
      *reinterpret_cast<uint32_t*>(dK + static_cast<size_t>(r0) * kD + c) =
          pack_bf16(dk[dt][0] * scale, dk[dt][1] * scale);
      *reinterpret_cast<uint32_t*>(dV + static_cast<size_t>(r0) * kD + c) =
          pack_bf16(dv[dt][0], dv[dt][1]);
    }
    if (r1 < M) {
      *reinterpret_cast<uint32_t*>(dK + static_cast<size_t>(r1) * kD + c) =
          pack_bf16(dk[dt][2] * scale, dk[dt][3] * scale);
      *reinterpret_cast<uint32_t*>(dV + static_cast<size_t>(r1) * kD + c) =
          pack_bf16(dv[dt][2], dv[dt][3]);
    }
  }
}

// dq pass: one block per (bh, 64 query rows), a loop over kv tiles of 64
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                    const __nv_bfloat16* __restrict__ V, const __nv_bfloat16* __restrict__ dO,
                    const float* __restrict__ LSE, const float* __restrict__ DSUM,
                    float* __restrict__ dQ, int N, int M, float scale) {
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

  Q += static_cast<size_t>(bh) * N * kD;
  dO += static_cast<size_t>(bh) * N * kD;
  dQ += static_cast<size_t>(bh) * N * kD;
  K += static_cast<size_t>(bh) * M * kD;
  V += static_cast<size_t>(bh) * M * kD;
  LSE += static_cast<size_t>(bh) * N;
  DSUM += static_cast<size_t>(bh) * N;

  load_tile(sQ, Q, q0, kRows, N);
  load_tile(sdO, dO, q0, kRows, N);

  // the two query rows this thread holds; rows past N are never stored
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const float l0 = row0 < N ? LSE[row0] * kLog2e : 0.f;
  const float l1 = row1 < N ? LSE[row1] * kLog2e : 0.f;
  const float ds0 = row0 < N ? DSUM[row0] : 0.f;
  const float ds1 = row1 < N ? DSUM[row1] : 0.f;
  const float sl2 = scale * kLog2e;

  float dq[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
  }

  for (int kv0 = 0; kv0 < M; kv0 += kTileN) {
    __syncthreads();  // the previous kv tile has been consumed
    load_tile(sK, K, kv0, kTileN, M);
    load_tile(sV, V, kv0, kTileN, M);
    __syncthreads();

    float s[NT][4], dp[NT][4];
    product_rows_by_rows<NT>(s, sQ, wr, sK, g, t);
    product_rows_by_rows<NT>(dp, sdO, wr, sV, g, t);

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
    product_frags_by_tile<KT>(dq, dsf, sK, lane);
  }

#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (row0 < N) {
      *reinterpret_cast<float2*>(dQ + static_cast<size_t>(row0) * kD + c) =
          make_float2(dq[dt][0] * scale, dq[dt][1] * scale);
    }
    if (row1 < N) {
      *reinterpret_cast<float2*>(dQ + static_cast<size_t>(row1) * kD + c) =
          make_float2(dq[dt][2] * scale, dq[dt][3] * scale);
    }
  }
}

// both above the 48 KB a launch gets without asking
constexpr size_t kDkdvSmem =
    sizeof(__nv_bfloat16) * (2 * kRows + 2 * kBlockQ) * kRow + sizeof(float) * 2 * kBlockQ;
constexpr size_t kDqSmem = sizeof(__nv_bfloat16) * (2 * kRows + 2 * kTileN) * kRow;

int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const __nv_bfloat16* dout, const float* lse, const float* dsum, float* dq,
           __nv_bfloat16* dk, __nv_bfloat16* dv, int BH, int N, int M, float scale,
           cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kDkdvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDqSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dk != nullptr) {
    const dim3 grid((M + kRows - 1) / kRows, BH);
    flash_bwd_dkdv_kernel<<<grid, kThreads, kDkdvSmem, st>>>(q, k, v, dout, lse, dsum, dk, dv,
                                                              N, M, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dq != nullptr) {
    const dim3 grid((N + kRows - 1) / kRows, BH);
    flash_bwd_dq_kernel<<<grid, kThreads, kDqSmem, st>>>(q, k, v, dout, lse, dsum, dq, N, M,
                                                         scale);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace ms

// ------------------------------------------------------------------------- //
// D=64: wgmma with a cp.async ring of swizzled tiles
// ------------------------------------------------------------------------- //
namespace wg {

using namespace hopper;

constexpr int kTile = 64;                   // rows of a warpgroup and of a streamed tile
constexpr int kGroups = 2;                  // consumer warpgroups per block
constexpr int kBlockRows = kGroups * kTile;
constexpr int kThreads = 128 * kGroups;
constexpr int kStages = 4;                  // ring of streamed tiles
constexpr int kAhead = kStages - 2;         // tiles in flight ahead of the consumed one
constexpr int kTileBytes = kTile * kRowBytes;              // 8 KB
constexpr int kResidentBytes = kGroups * kTileBytes;       // the block's rows of A1 or A2
constexpr int kStageBytes = 2 * kTileBytes;                // the two streamed tiles

// the dk/dv pass holds its rows in registers and streams lse and dsum with
// its columns; the dq pass keeps its rows, and their lse and dsum, to itself
constexpr size_t smem_bytes(bool dq) {
  return 1024                                              // slack to align the base
         + (dq ? 2 * kResidentBytes : kStages * 2 * kTile * sizeof(float))
         + kStages * kStageBytes;
}

// P (or P^T) of one tile from its logits x in place, and its bf16 A
// fragments: p = exp2(x * sl2 - l) with l = lse * log2(e) of the element's
// query (the accumulator row in the dq pass, the column in the dk/dv pass).
// With kMask, columns from `cols_left` on are past the end and get p = 0;
// only the last tile of a ragged length needs it.
template <bool kMask, bool kDQ>
__device__ __forceinline__ void probabilities(float (&x)[32], uint32_t (&pf)[4][4],
                                              const float* sL, const float (&l_row)[2],
                                              float sl2, int t, int cols_left) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, col = 8 * j + 2 * t + (e & 1);
      const float l = kDQ ? l_row[e >> 1] : sL[col] * kLog2e;
      x[i] = (!kMask || col < cols_left) ? exp2f(x[i] * sl2 - l) : 0.f;
    }
    pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(x[4 * j + 0], x[4 * j + 1]);
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// Both passes. Rows are what a block owns and keeps for the whole loop (A1,
// A2), columns what it streams through the ring (B1, B2):
//   kDQ = false, the dk/dv pass: rows = kv (A1 = K, A2 = V), columns = queries
//     (B1 = Q, B2 = dO, with lse and dsum per column);
//   kDQ = true, the dq pass: rows = queries (A1 = Q, A2 = dO, lse and dsum per
//     row), columns = kv (B1 = K, B2 = V).
// Per column tile: X = A1 B1^T, Y = A2 B2^T, P = exp(X scale - lse) (zero for
// columns past their end), dS = P (Y - dsum); the dk/dv pass adds P B2 to dV
// and dS B1 to dK, the dq pass dS B1 to dQ.
//
// The dk/dv pass holds its rows as register A fragments (32 registers more,
// half the shared-memory reads of an operand pair); the dq pass keeps them in
// shared memory, which holds it to 128 registers and two blocks an SM.
//
// The products of a tile are waited on one group at a time: X while Y runs,
// Y while dV runs.
//
// The wgmma accumulator of a warpgroup's 64 x 64 tile: thread (warp w, lane
// = 4g + t) holds element i at row 16w + g + 8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + 2t + (i & 1).
template <bool kDQ>
__global__ void __launch_bounds__(kThreads, kDQ ? 2 : 1)
flash_bwd_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                 const bf16* __restrict__ V, const bf16* __restrict__ dO,
                 const float* __restrict__ LSE, const float* __restrict__ DSUM,
                 float* __restrict__ dQ, bf16* __restrict__ dK, bf16* __restrict__ dV, int N,
                 int M, float scale) {
  constexpr bool kRowsInSmem = kDQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes
  const uint32_t sA1 = base, sA2 = base + kResidentBytes;  // kRowsInSmem only
  const uint32_t sRing = base + (kRowsInSmem ? 2 * kResidentBytes : 0);
  float* sStat = reinterpret_cast<float*>(smem_raw + (sRing - raw) +
                                          kStages * kStageBytes);  // [stage][lse, dsum][64]

  const int bh = blockIdx.y;
  Q += static_cast<size_t>(bh) * N * kD;
  dO += static_cast<size_t>(bh) * N * kD;
  K += static_cast<size_t>(bh) * M * kD;
  V += static_cast<size_t>(bh) * M * kD;
  LSE += static_cast<size_t>(bh) * N;
  DSUM += static_cast<size_t>(bh) * N;
  const bf16* A1 = kDQ ? Q : K;
  const bf16* A2 = kDQ ? dO : V;
  const bf16* B1 = kDQ ? K : Q;
  const bf16* B2 = kDQ ? V : dO;
  const int row_len = kDQ ? N : M;
  const int col_len = kDQ ? M : N;
  const int r0 = blockIdx.x * kBlockRows;
  const int n_tiles = (col_len + kTile - 1) / kTile;

  const int tid = threadIdx.x;
  const int group = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  auto load_columns = [&](int j) {
    const uint32_t stage = sRing + (j % kStages) * kStageBytes;
    load_tile<kTile, kThreads>(stage, B1, j * kTile, col_len);
    load_tile<kTile, kThreads>(stage + kTileBytes, B2, j * kTile, col_len);
    if (!kDQ && tid < 2 * kTile) {
      const int c = j * kTile + (tid & (kTile - 1));
      const float* src = tid < kTile ? LSE : DSUM;
      cp_async_4(smem_u32(sStat + (j % kStages) * 2 * kTile + tid), c < N ? src + c : src,
                 c < N);
    }
  };

  // the block's rows (dq pass) and the first kAhead column tiles, one group each
  if constexpr (kRowsInSmem) {
    load_tile<kBlockRows, kThreads>(sA1, A1, r0, row_len);
    load_tile<kBlockRows, kThreads>(sA2, A2, r0, row_len);
  }
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < n_tiles) load_columns(j);
    cp_async_commit();
  }

  // the block's rows this thread holds (dk/dv pass), and, in the dq pass,
  // their lse (base 2) and dsum
  const int row = r0 + group * kTile + warp * 16 + g;  // and row + 8
  uint32_t a1[4][4], a2[4][4];
  if constexpr (!kRowsInSmem) {
    load_fragments(a1, A1, row, row_len, t);
    load_fragments(a2, A2, row, row_len, t);
  }
  const uint64_t dA1 = desc_k_major(sA1 + group * kTileBytes);
  const uint64_t dA2 = desc_k_major(sA2 + group * kTileBytes);
  float l_row[2] = {0.f, 0.f}, d_row[2] = {0.f, 0.f};
  if (kDQ) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row + 8 * h < N) {
        l_row[h] = LSE[row + 8 * h] * kLog2e;
        d_row[h] = DSUM[row + 8 * h];
      }
    }
  }
  const float sl2 = scale * kLog2e;

  float acc0[32], acc1[32], x[32], y[32];  // acc0 dV, acc1 dK or dQ; x S, y dP
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = x[i] = y[i] = 0.f;
  uint32_t pf[4][4], df[4][4];  // bf16 A fragments of P and dS, 16 columns each

  for (int it = 0; it < n_tiles; ++it) {
    // the stage written here was consumed two tiles back: every thread has
    // passed the barrier below since then
    if (it + kAhead < n_tiles) load_columns(it + kAhead);
    cp_async_commit();
    cp_async_wait<kAhead>();  // this thread's copies of tile `it` have landed
    fence_async_proxy();
    __syncthreads();          // and everyone else's

    const int s = it % kStages;
    const uint32_t sB1 = sRing + s * kStageBytes, sB2 = sB1 + kTileBytes;
    const uint64_t dB1 = desc_k_major(sB1), dB2 = desc_k_major(sB2);
    const float* sL = sStat + s * 2 * kTile;
    const float* sDs = sL + kTile;

    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      if constexpr (kRowsInSmem) {
        wgmma_ss(x, dA1 + 2 * ks, dB1 + 2 * ks, ks);
      } else {
        wgmma_rs<0>(x, a1[ks], dB1 + 2 * ks, ks);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      if constexpr (kRowsInSmem) {
        wgmma_ss(y, dA2 + 2 * ks, dB2 + 2 * ks, ks);
      } else {
        wgmma_rs<0>(y, a2[ks], dB2 + 2 * ks, ks);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // X is done; Y runs on
    keep(x);

    const int cols_left = col_len - it * kTile;
    if (cols_left >= kTile) {
      probabilities<false, kDQ>(x, pf, sL, l_row, sl2, t, cols_left);
    } else {
      probabilities<true, kDQ>(x, pf, sL, l_row, sl2, t, cols_left);
    }
    if constexpr (!kDQ) {
      // dV += P^T dO: the 16 columns of step kk are rows 16kk.. of the dO tile
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        wgmma_rs<1>(acc0, pf[kk], desc_mn_major(sB2 + kk * 16 * kRowBytes), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // Y is done; the dV product runs on
    } else {
      wgmma_wait<0>();
    }
    keep(y);

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, col = 8 * j + 2 * t + (e & 1);
        ds[e] = x[i] * (y[i] - (kDQ ? d_row[e >> 1] : sDs[col]));
      }
      df[j >> 1][(j & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      df[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dK += dS^T Q (dk/dv pass) or dQ += dS K (dq pass)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_rs<1>(acc1, df[kk], desc_mn_major(sB1 + kk * 16 * kRowBytes), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();  // the stage and the fragments are free again
    keep(acc1);
    keep(df);
    if constexpr (!kDQ) {
      keep(acc0);
      keep(pf);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= row_len) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t, i = 4 * j + 2 * h;
      const size_t at = (static_cast<size_t>(bh) * row_len + r) * kD + c;
      if constexpr (kDQ) {
        *reinterpret_cast<float2*>(dQ + at) = make_float2(acc1[i] * scale, acc1[i + 1] * scale);
      } else {
        *reinterpret_cast<uint32_t*>(dK + at) = pack_bf16(acc1[i] * scale, acc1[i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dV + at) = pack_bf16(acc0[i], acc0[i + 1]);
      }
    }
  }
}

template <bool kDQ>
cudaError_t launch_pass(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                        const float* lse, const float* dsum, float* dq, bf16* dk, bf16* dv,
                        int BH, int N, int M, float scale, cudaStream_t st) {
  constexpr size_t smem = smem_bytes(kDQ);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<kDQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(((kDQ ? N : M) + kBlockRows - 1) / kBlockRows, BH);
  flash_bwd_kernel<kDQ><<<grid, kThreads, smem, st>>>(q, k, v, dout, lse, dsum, dq, dk, dv, N,
                                                      M, scale);
  return cudaGetLastError();
}

int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
           const float* dsum, float* dq, bf16* dk, bf16* dv, int BH, int N, int M, float scale,
           cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  if (dk != nullptr) {
    err = launch_pass<false>(q, k, v, dout, lse, dsum, dq, dk, dv, BH, N, M, scale, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dq != nullptr) {
    err = launch_pass<true>(q, k, v, dout, lse, dsum, dq, dk, dv, BH, N, M, scale, st);
  }
  return static_cast<int>(err);
}

}  // namespace wg

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
    return wg::launch(qp, kp, vp, dop, lp, dsp, dqp, dkp, dvp, BH, N, M, scale, st);
  }
  if (D == 128) {
    return ms::launch(qp, kp, vp, dop, lp, dsp, dqp, dkp, dvp, BH, N, M, scale, st);
  }
  return -1;
}
