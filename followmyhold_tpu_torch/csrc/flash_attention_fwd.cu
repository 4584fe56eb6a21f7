// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 statistics.
//
// Replaces the TPU kernel `_flash_kernel` launched by `_flash_attention_pallas`
// in followmyhold_tpu/ops/attention.py: O = softmax(Q K^T * scale) V with an
// online softmax over kv tiles, products in bf16 with f32 accumulation, the
// ragged kv tail masked inside the kernel, and the per-row logsumexp (natural
// log) emitted beside O: the flash backward reads it.
//
// What bounds it on this card: operations. At the main-path shapes the
// 4*B*H*N*M*D flops outweigh the Q, K, V, O bytes by more than the card's
// ~295 flop/byte ridge, so the floor is the bf16 tensor-core rate, which only
// wgmma reaches. At D=64 a 64 x 64 tile's two products take ~256 tensor
// cycles of an SM and its 4096 exponentials as many cycles of the SM's
// special-function units, so the softmax has to run beside the products.
//
// What the design does about it. The TPU version held the whole kv set of a
// head in fast memory (up to 3072 x 64 for K and for V); that is 768 KB and a
// block here has 227 KB, so kv streams through shared memory in tiles of 64
// rows. Blocks run in any order and share nothing; each owns 128 query rows
// of one (batch, head) and sweeps all of its kv:
//   - two warpgroups a block, 64 query rows each; a thread holds its two rows
//     of Q as register A fragments, loaded once;
//   - K and V tiles arrive through a ring of six stages, two tiles ahead of
//     the one consumed, by the tensor-memory accelerator (TMA): one thread
//     asks for a tile and the hardware writes it in the 128-byte swizzled
//     layout that the wgmma descriptors name, zero-filling rows past M, so
//     the math warps spend no instructions on copies. A stage's "full"
//     mbarrier counts the tile's bytes in; its "empty" mbarrier counts every
//     thread's release once the tile's last product is done. There is no
//     block barrier in the loop, so the two warpgroups run apart;
//   - S = Q K^T is wgmma.m64n64k16 with K read K-major; the online softmax
//     runs on the accumulator registers (a row lives in the four threads of a
//     quad: two shuffles per reduction), with scale * log2(e) folded into
//     ex2.approx; P is converted to bf16 in the registers it came out of,
//     which is the register A operand of O += P V, and V is read MN-major
//     through the transpose bit, so P never touches shared memory;
//   - the products are pipelined within a warpgroup: S of tile j and P V of
//     tile j-1 are issued together, the softmax of tile j runs while P V of
//     tile j-1 is on the tensor cores, and O is rescaled once that is done;
//   - only the last tile of a ragged M pays for the column mask; query rows
//     past N read zeros and are never stored.
// Both head sizes of the main path take this design. A tile is a stack of
// 64-column panels (one at D=64, two at D=128), each one swizzle span wide,
// so every product reads within one panel: S sums over the panels of Q and
// K, and O is one 64-column accumulator per panel of V.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;
using hopper::keep;

constexpr float kNegBig = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Tiles are stacks of 64-column panels of 64 rows: a panel row is 128 bytes,
// one swizzle span, so every operand a product reads lies in one panel.
constexpr int kTile = 64;                      // query rows of a warpgroup; kv rows of a tile
constexpr int kGroups = 2;                     // warpgroups per block
constexpr int kBlockRows = kGroups * kTile;
constexpr int kThreads = 128 * kGroups;
constexpr int kPanelBytes = kTile * kRowBytes;  // 8 KB
constexpr int kStages = 6;                     // ring of K/V tiles
constexpr int kAhead = 2;                      // tiles asked for ahead of the one consumed

template <int kDim>
struct Shape {
  static constexpr int kPanels = kDim / 64;
  static constexpr int kStageBytes = 2 * kPanels * kPanelBytes;  // K tile, then V tile
  // 1024: slack to align the ring; then two mbarriers a stage
  static constexpr size_t kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
};

// The tensor-memory accelerator's copies of K and V tiles and the mbarriers
// that count their bytes. One thread asks for a tile; the hardware writes it
// in the 128-byte swizzled layout (the tensor map says so) and zero-fills
// rows past M.
__device__ __forceinline__ void mbarrier_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbarrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbarrier_expect_bytes(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// the 64 x 64 box at (column col, row row, head bh) of a [BH, M, D] tensor
// into the panel at shared `dst`
__device__ __forceinline__ void tma_load_panel(uint32_t dst, const CUtensorMap* map, int col,
                                               int row, int bh, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bh), "r"(bar)
      : "memory");
}

// 2^x on the special-function unit; inputs and results below 2^-126 are
// flushed to zero (a probability that small adds nothing to a bf16 P or to
// the f32 row sum)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one tile on the S accumulator x, in place: new row
// maxima m (raw scores), the factor alpha that takes the previous tiles'
// sums to them, the row sums l (this thread's columns only), and
// P = exp2(x * sl2 - m * sl2) in x. With kMask, columns from `cols_left` on
// are past M and get p = 0; only the last tile of a ragged M needs it.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&x)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float sl2, int t,
                                             int cols_left) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (kMask && 8 * (i >> 2) + 2 * t + (i & 1) >= cols_left) x[i] = kNegBig;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x[i]);
  }
  float off[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = exp2_ftz((m[h] - mx[h]) * sl2);
    m[h] = mx[h];
    off[h] = mx[h] * sl2;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    x[i] = exp2_ftz(fmaf(x[i], sl2, -off[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += x[i];
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// P in bf16, as the register A fragments of O += P V: the accumulator's
// 8-column groups 2kk and 2kk + 1 are the 16 columns of step kk
__device__ __forceinline__ void to_fragments(const float (&x)[32], uint32_t (&pf)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(x[4 * j + 0], x[4 * j + 1]);
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// S = Q K^T against the K tile at shared address sK, read K-major: the 16
// columns of step ks lie in panel ks / 4
template <int kSteps>
__device__ __forceinline__ void qk_product(float (&s)[32], const uint32_t (&qf)[kSteps][4],
                                           uint32_t sK) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    wgmma_rs<0>(s, qf[ks], desc_k_major(sK + (ks >> 2) * kPanelBytes) + 2 * (ks & 3), ks);
  }
}

// O += P V with the V tile at shared address sV, read MN-major: panel p of V
// gives the 64 output columns of o[p]; the 16 columns of P in step kk meet
// rows 16kk.. of it
template <int kPanels>
__device__ __forceinline__ void pv_product(float (&o)[kPanels][32], const uint32_t (&pf)[4][4],
                                           uint32_t sV) {
#pragma unroll
  for (int p = 0; p < kPanels; ++p) {
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_rs<1>(o[p], pf[kk], desc_mn_major(sV + p * kPanelBytes + kk * 16 * kRowBytes), 1);
    }
  }
}

template <int kPanels>
__device__ __forceinline__ void keep(float (&o)[kPanels][32]) {
#pragma unroll
  for (int p = 0; p < kPanels; ++p) hopper::keep(o[p]);
}

// One block: kBlockRows query rows of one (batch, head), a warpgroup per 64.
// Per kv tile j > 0: S_j = Q K_j^T and O += P_{j-1} V_{j-1} are issued
// together; once S_j is in, its softmax runs while the P V product does;
// then O *= alpha_j and P_j goes into the A fragments, which the product has
// released. Tile 0 has no P V before it, and the last tile's follows the loop.
// No register that an issued product reads or writes is touched before its
// wait, so ptxas keeps the products asynchronous.
template <int kDim>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tmK, const __grid_constant__ CUtensorMap tmV,
                 const bf16* __restrict__ Q, bf16* __restrict__ O, float* __restrict__ LSE,
                 int N, int M, float scale) {
  using S = Shape<kDim>;
  constexpr int kPanels = S::kPanels;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle repeats every 1 KB
  const uint32_t bars = ring + kStages * S::kStageBytes;  // full[stage], then empty[stage]

  const int bh = blockIdx.y;
  Q += static_cast<size_t>(bh) * N * kDim;
  const int n_tiles = (M + kTile - 1) / kTile;

  const int tid = threadIdx.x;
  const int group = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  auto stage = [&](int j) { return ring + (j % kStages) * S::kStageBytes; };
  auto full = [&](int j) { return bars + (j % kStages) * 8; };
  auto empty = [&](int j) { return bars + (kStages + j % kStages) * 8; };
  // Thread 0 asks for tile j once every thread has released the tile that
  // held its stage before (j - kStages): the phases of both mbarriers of a
  // stage flip once per use of the stage.
  auto load_kv = [&](int j) {
    if (j >= kStages) mbarrier_wait(empty(j), (j / kStages - 1) & 1);
    mbarrier_expect_bytes(full(j), S::kStageBytes);
    for (int p = 0; p < kPanels; ++p) {
      tma_load_panel(stage(j) + p * kPanelBytes, &tmK, 64 * p, j * kTile, bh, full(j));
      tma_load_panel(stage(j) + (kPanels + p) * kPanelBytes, &tmV, 64 * p, j * kTile, bh,
                     full(j));
    }
  };
  // Tile j was asked for kAhead tiles before; the warpgroups run apart, up
  // to kStages - kAhead - 1 tiles, with no block barrier in the loop.
  auto arrive = [&](int j) {
    if (tid == 0 && j + kAhead < n_tiles) load_kv(j + kAhead);
    mbarrier_wait(full(j), (j / kStages) & 1);
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbarrier_init(full(i), 1);
      mbarrier_init(empty(i), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < kAhead && j < n_tiles; ++j) load_kv(j);
  }
  __syncthreads();  // the mbarriers are initialised

  const int row = blockIdx.x * kBlockRows + group * kTile + warp * 16 + g;  // and row + 8
  uint32_t qf[kDim / 16][4];
  load_fragments(qf, Q, row, N, t);
  const float sl2 = scale * kLog2e;

  float o[kPanels][32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int p = 0; p < kPanels; ++p) o[p][i] = 0.f;
  }
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pf[4][4];  // bf16 A fragments of P
  auto softmax = [&](int j) {
    const int cols_left = M - j * kTile;
    if (cols_left >= kTile) {
      softmax_tile<false>(s, m, l, alpha, sl2, t, cols_left);
    } else {
      softmax_tile<true>(s, m, l, alpha, sl2, t, cols_left);
    }
  };

  arrive(0);
  keep(qf);
  keep(s);
  wgmma_fence();
  qk_product(s, qf, stage(0));
  wgmma_commit();
  wgmma_wait<0>();
  keep(s);
  softmax(0);  // O is still zero: alpha is not needed
  to_fragments(s, pf);

  for (int it = 1; it < n_tiles; ++it) {
    arrive(it);
    keep(s);
    keep(o);
    keep(pf);
    wgmma_fence();
    qk_product(s, qf, stage(it));
    wgmma_commit();
    pv_product(o, pf, stage(it - 1) + kPanels * kPanelBytes);
    wgmma_commit();
    wgmma_wait<1>();  // S is in; P V runs on
    keep(s);
    softmax(it);
    wgmma_wait<0>();  // P V of the previous tile is done, and with it the tile
    keep(o);
    keep(pf);
    mbarrier_arrive(empty(it - 1));
#pragma unroll
    for (int i = 0; i < 32; ++i) {
#pragma unroll
      for (int p = 0; p < kPanels; ++p) o[p][i] *= alpha[(i >> 1) & 1];
    }
    to_fragments(s, pf);
  }

  keep(o);
  keep(pf);
  wgmma_fence();
  pv_product(o, pf, stage(n_tiles - 1) + kPanels * kPanelBytes);
  wgmma_commit();
  wgmma_wait<0>();
  keep(o);
  keep(pf);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= N) continue;
    const float inv = 1.f / l[h];
    bf16* orow = O + (static_cast<size_t>(bh) * N + r) * kDim;
#pragma unroll
    for (int p = 0; p < kPanels; ++p) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<uint32_t*>(orow + 64 * p + 8 * j + 2 * t) =
            pack_bf16(o[p][i] * inv, o[p][i + 1] * inv);
      }
    }
    if (t == 0) LSE[static_cast<size_t>(bh) * N + r] = m[h] * scale + logf(l[h]);
  }
}

// The tensor map of a [BH, M, D] bf16 tensor in 64 x 64 boxes, 128-byte
// swizzled; rows past M read as zeros. cuTensorMapEncodeTiled is looked up
// through the runtime's entry-point query, so the library needs no link to
// libcuda.
cudaError_t tile_map(CUtensorMap* map, const bf16* x, int BH, int M, int D) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                              reinterpret_cast<void**>(&encode),
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(M),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(M) * D * 2};  // bytes, dims 1, 2
  const cuuint32_t box[3] = {64, kTile, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(x), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kDim>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int BH,
                   int N, int M, float scale, cudaStream_t st) {
  constexpr size_t smem = Shape<kDim>::kSmemBytes;
  CUtensorMap tmK, tmV;
  cudaError_t err = tile_map(&tmK, k, BH, M, kDim);
  if (err == cudaSuccess) err = tile_map(&tmV, v, BH, M, kDim);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<kDim>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlockRows - 1) / kBlockRows, BH);
  flash_fwd_kernel<kDim><<<grid, kThreads, smem, st>>>(tmK, tmV, q, o, lse, N, M, scale);
  return cudaGetLastError();
}

}  // namespace

// q [BH,N,D], k and v [BH,M,D], o [BH,N,D] bf16 contiguous; lse [BH,N] f32.
// Returns cudaGetLastError() after the launch, or -1 for a head size the
// kernels are not instantiated for.
extern "C" int fmh_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int BH, int N, int M, int D, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  if (D == 64) return static_cast<int>(launch<64>(qp, kp, vp, op, lp, BH, N, M, scale, st));
  if (D == 128) return static_cast<int>(launch<128>(qp, kp, vp, op, lp, BH, N, M, scale, st));
  return -1;
}
