// Hopper (sm_90a) building blocks shared by the flash-attention kernels:
// asynchronous copies into 128-byte swizzled tiles, the wgmma shared-memory
// descriptors of those tiles, and m64n64k16 products with A from shared
// memory or from registers.
//
// A bf16 row of 64 elements is 128 bytes, one swizzle span, so a tile of 64
// columns is a stack of 1024-byte swizzle atoms of 8 rows each; wider rows
// are kept as several such tiles side by side.
//
// The wgmma accumulator of a warpgroup's 64 x 64 tile: thread (warp w, lane
// = 4g + t) holds element i at row 16w + g + 8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + 2t + (i & 1). Two adjacent 8-column groups of it, converted
// to bf16 pairs, are the register A fragment of a product over those 16
// columns (`load_fragments` gives the same layout from global memory).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;             // columns of a tile: the whole row at head size 64
constexpr int kRowBytes = kD * 2;  // a bf16 row: the 128-byte swizzle span

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled where !valid
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the async one
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [r0, r0 + kRows) of a [len, 64] bf16 matrix into the tile at shared
// address `dst` (1024-byte aligned), 128-byte swizzled: the 16-byte chunk c of
// row r lands in chunk c ^ (r % 8) of that row. Rows past len are zero. All
// kThreads threads of the block take part.
template <int kRows, int kThreads>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int r0, int len) {
  static_assert(kRows * 8 % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int n = 0; n < kRows * 8 / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i >> 3, c = i & 7;
    const bool in = r0 + r < len;
    cp_async_16(dst + r * kRowBytes + ((c ^ (r & 7)) << 4),
                in ? src + static_cast<size_t>(r0 + r) * kD + c * 8 : src, in);
  }
}

// wgmma shared-memory descriptors of a swizzled tile (128-byte swizzle, bits
// 62-63 = 1; addresses and strides in 16-byte units). K-major (each row holds
// the reduction axis): 8-row groups 1024 bytes apart; a step of 16 along the
// reduction adds 32 bytes to the start. MN-major (rows are the reduction
// axis, read through the transpose bit): the 8-row groups along the reduction
// are 1024 bytes apart; at N=64 the tile is one swizzle atom wide, so the
// other stride is never used and both are given the same value.
__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return static_cast<uint64_t>((bytes & 0x3FFFF) >> 4);
}
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return desc_field(addr) | desc_field(16) << 16 | desc_field(1024) << 32 | 1ull << 62;
}
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return desc_field(addr) | desc_field(1024) << 16 | desc_field(1024) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving register reads or writes across a wait
template <int K>
__device__ __forceinline__ void keep(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int K>
__device__ __forceinline__ void keep(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

#define FMH_WGMMA_D32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FMH_WGMMA_ACC32(d)                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d[64x64] (+)= A[64x16] B[16x64], both from shared memory, both K-major.
// `accumulate` = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FMH_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FMH_WGMMA_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64x64] (+)= A[64x16] B[16x64]: A from registers (four bf16 pairs a
// thread: rows 16w + g and + 8, columns 2t, 2t + 1 and + 8 of each warp's 16
// rows, mma.sync's A fragment), B from shared memory, K-major or, with
// kTransB, MN-major. `accumulate` = 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FMH_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : FMH_WGMMA_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

#undef FMH_WGMMA_D32
#undef FMH_WGMMA_ACC32

// A fragments of rows [row, row + 8] (the two of this thread) of a
// [len, 16 * kSteps] bf16 matrix for its kSteps 16-column steps; rows past
// len are zero
template <int kSteps>
__device__ __forceinline__ void load_fragments(uint32_t (&f)[kSteps][4], const bf16* src,
                                               int row, int len, int t) {
  constexpr int kCols = 16 * kSteps;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row + 8 * h < len;
    const uint32_t* p =
        reinterpret_cast<const uint32_t*>(src + static_cast<size_t>(in ? row + 8 * h : 0) * kCols) +
        t;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      f[ks][h] = in ? __ldg(p + 8 * ks) : 0u;          // columns 16ks + 2t
      f[ks][h + 2] = in ? __ldg(p + 8 * ks + 4) : 0u;  // columns 16ks + 8 + 2t
    }
  }
}

}  // namespace hopper
