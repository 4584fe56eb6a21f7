// Deterministic row scatter-add for Hopper (sm_90a): out[r] = sum of src[i]
// over the i with index[i] == r, with bits that do not change from run to run.
//
// No Pallas kernel of the JAX package stands behind it: there, the gradient of
// a gather (`x[idx]`, e.g. the rasterizer's per-pixel face rows in
// followmyhold_tpu/ops/rasterizer.py) is XLA's scatter-add, which a TPU runs
// in a fixed order. PyTorch's `index_add_` adds with float atomics on the card,
// so duplicates land in another order every run and two calls of an
// optimisation drift apart. Sorting the indices and summing each run in a
// fixed order fixes that too, but the stable sort alone spends a dozen
// launches and most of the device time of such a call, on a host that already
// limits the iteration.
//
// What bounds it on this card: bytes (each index and source value read once,
// each output written once), and the atomics of one row, which meet in one L2
// line, as index_add_'s do; a warp folds equal neighbouring rows first.
//
// What the design does about it: it adds in fixed point. Integer addition is
// associative, so 64-bit integer atomics give the same sum in any order.
//   1. Each output row's largest finite |term| M, by an atomic max over the
//      float bits (which order as the values do).
//   2. Every term times 2^k, rounded to an integer, added into its 64-bit
//      accumulator, with the row's own k = 61 - L - e, where 2^e <= M <
//      2^(e+1) and n <= 2^L: no sum of n terms can reach 2^62. Each term is
//      off by at most 2^-(k+1) <= M 2^(L-62), M 2^-44 at n <= 2^18: far below
//      the float rounding of the row's largest term, so below what float
//      atomics lose.
//   3. Each accumulator back to float (one rounding) and times 2^-k.
// A row that receives a NaN or an infinity is NaN. Four launches (a memset and
// three kernels) from one call; nothing is read back to the host.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;     // grid-stride loops beyond this
constexpr float kFloatMax = 3.4028235e38f;

// A warp takes 32 consecutive terms, a lane each. Lanes with the same row in a
// contiguous stretch (the per-pixel gathers have long ones) form a segment;
// `combine` folds each segment into its last lane by shuffles, so one atomic
// goes out per segment. Max and integer sums do not depend on the order, so
// neither does the result.
struct Segments {
  int id;     // segment number of this lane within the warp
  bool last;  // this lane ends its segment
};

__device__ __forceinline__ Segments segments_of(long long row, int lane) {
  const long long prev = __shfl_up_sync(0xffffffffu, row, 1);
  const long long next = __shfl_down_sync(0xffffffffu, row, 1);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != row);
  Segments s;
  s.id = __popc(heads & (0xffffffffu >> (31 - lane)));
  s.last = lane == 31 || next != row;
  return s;
}

template <typename T, typename Op>
__device__ __forceinline__ T combine(T v, const Segments& s, int lane, Op op) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T u = __shfl_up_sync(0xffffffffu, v, off);
    const int id = __shfl_up_sync(0xffffffffu, s.id, off);
    if (lane >= off && id == s.id) v = op(v, u);
  }
  return v;
}

// the exponent k of a row's fixed-point scale 2^k, from its largest |term|
__device__ __forceinline__ int scale_exponent(unsigned max_bits, int log2_n) {
  if (max_bits == 0) return 0;  // all zeros
  const int e = ilogbf(__uint_as_float(max_bits));
  return min(61 - log2_n - e, 120);  // at most 120: 2^k stays a finite float
}

// Both passes walk the terms a warp at a time (the loop bound is the same for
// every lane of a warp, as the shuffles need); `valid` masks the tail.
__global__ void __launch_bounds__(kThreads)
row_max_kernel(const long long* __restrict__ index, const float* __restrict__ src, int n,
               int cols, unsigned* __restrict__ row_max, int* __restrict__ bad) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long base = blockIdx.x * static_cast<long long>(kThreads) + (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long e = base + lane;
    const bool valid = e < n;
    const long long row = valid ? index[e] : -1;
    unsigned m = 0;
    int nonfinite = 0;
    for (int c = 0; valid && c < cols; ++c) {
      const float v = fabsf(src[e * cols + c]);
      if (v <= kFloatMax) m = max(m, __float_as_uint(v));  // bits order as values
      else nonfinite = 1;
    }
    const Segments seg = segments_of(row, lane);
    m = combine(m, seg, lane, [](unsigned a, unsigned b) { return max(a, b); });
    nonfinite = combine(nonfinite, seg, lane, [](int a, int b) { return a | b; });
    if (valid && seg.last) {
      if (m != 0) atomicMax(row_max + row, m);
      if (nonfinite) atomicOr(bad + row, 1);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
add_kernel(const long long* __restrict__ index, const float* __restrict__ src, int n, int cols,
           int log2_n, const unsigned* __restrict__ row_max,
           unsigned long long* __restrict__ acc) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long base = blockIdx.x * static_cast<long long>(kThreads) + (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long e = base + lane;
    const bool valid = e < n;
    const long long row = valid ? index[e] : -1;
    const float scale =
        valid ? exp2f(static_cast<float>(scale_exponent(row_max[row], log2_n))) : 0.f;
    const Segments seg = segments_of(row, lane);
    for (int c = 0; c < cols; ++c) {
      const float v = valid ? src[e * cols + c] : 0.f;
      // a non-finite term adds nothing: its row comes out NaN
      long long q = fabsf(v) <= kFloatMax ? __float2ll_rn(v * scale) : 0;
      // two's complement: the sums wrap as the signed sums do
      q = combine(q, seg, lane, [](long long a, long long b) {
        return static_cast<long long>(static_cast<unsigned long long>(a) +
                                      static_cast<unsigned long long>(b));
      });
      if (valid && seg.last && q != 0) {
        atomicAdd(acc + row * cols + c, static_cast<unsigned long long>(q));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
finish_kernel(const unsigned long long* __restrict__ acc, const unsigned* __restrict__ row_max,
              const int* __restrict__ bad, int n_rows, int cols, int log2_n,
              float* __restrict__ out) {
  const long long total = static_cast<long long>(n_rows) * cols;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long row = i / cols;
    const int k = scale_exponent(row_max[row], log2_n);
    const float sum = ldexpf(__ll2float_rn(static_cast<long long>(acc[i])), -k);
    out[i] = bad[row] ? __int_as_float(0x7fc00000) : sum;  // NaN where a term was
  }
}

int blocks_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// index i64 [n] (each in [0, n_rows)), src f32 [n, cols]; out f32
// [n_rows, cols], every entry written; scratch of 8 n_rows (cols + 1) bytes,
// 8-byte aligned. Returns cudaGetLastError() after the launches.
extern "C" int fmh_scatter_rows_add(const void* index, const void* src, void* out,
                                    void* scratch, int n, int n_rows, int cols, void* stream) {
  if (n_rows < 1 || cols < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(n_rows) * cols;
  auto* acc = static_cast<unsigned long long*>(scratch);           // [n_rows * cols]
  auto* row_max = reinterpret_cast<unsigned*>(acc + cells);        // [n_rows]
  int* bad = reinterpret_cast<int*>(row_max + n_rows);             // [n_rows]
  const size_t bytes = 8 * static_cast<size_t>(cells) + 8 * static_cast<size_t>(n_rows);
  cudaError_t err = cudaMemsetAsync(scratch, 0, bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int log2_n = 0;
  while ((1LL << log2_n) < n) ++log2_n;
  const auto* idx = static_cast<const long long*>(index);
  const float* x = static_cast<const float*>(src);
  row_max_kernel<<<blocks_for(n), kThreads, 0, s>>>(idx, x, n, cols, row_max, bad);
  add_kernel<<<blocks_for(n), kThreads, 0, s>>>(idx, x, n, cols, log2_n, row_max, acc);
  finish_kernel<<<blocks_for(cells), kThreads, 0, s>>>(acc, row_max, bad, n_rows, cols, log2_n,
                                                      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
