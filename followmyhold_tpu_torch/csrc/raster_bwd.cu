// Tiled rasterizer, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_raster_bwd_kernel` in
// followmyhold_tpu/ops/rasterizer.py: the closed-form gradient of (w1, w2, vis)
// with respect to the six screen x/y of every binned face (z gets zero: depth
// flows through the interpolation outside the kernel).
//   winner chain:   w_k = e_k / area, edge and area product rules, masked to
//                   the pixels whose winning slot is this face;
//   coverage chain: gcov = gvis * (-vis / (1 - cov)), zero where the coverage is
//                   clipped or the face degenerate, passed through the minimum
//                   of the three segment distances; the nearest point's
//                   parameter t minimises the distance, so its own derivative
//                   drops out (envelope theorem).
//
// What bounds it on this card: operations in f32, as in the forward, plus one
// block-wide sum of six numbers per face.
//
// What the design does about it. One block owns one 16x16 tile and walks that
// tile's faces, so each (tile, slot) column of `dgeom[9, P]` has exactly one
// writer: no atomics, and the result does not change from run to run. (Adding
// straight into per-face gradients with f32 atomics would save the later
// index_add over tiles but give sums whose order changes between runs; the
// optimizer loop that sits on this gradient is easier to hold against its
// reference when it is deterministic.) The per-face sums over the tile's
// pixels are warp shuffles followed by a sum over the 8 warps' partials in
// shared memory, taken for 8 faces at a time so the block synchronises twice
// per 8 faces; a warp in which no pixel has a gradient for the face skips its
// shuffles.

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;  // faces reduced together

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
raster_bwd_kernel(const float* __restrict__ geom, const int* __restrict__ tile_start,
                  const int* __restrict__ slot_in, const float* __restrict__ vis_in,
                  const float* __restrict__ gw1_in, const float* __restrict__ gw2_in,
                  const float* __restrict__ gvis_in, float* __restrict__ dgeom, int P,
                  int tiles_x, float csig) {
  __shared__ Face sf[kStage];
  __shared__ float part[kWarps][kBatch][6];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float uu = static_cast<float>((tile % tiles_x) * kTileW + tid % kTileW);
  const float vv = static_cast<float>((tile / tiles_x) * kTileH + tid / kTileW);
  const int beg = tile_start[tile], end = tile_start[tile + 1];

  const int px = tile * kThreads + tid;
  const int win_slot = slot_in[px];
  const float vis = vis_in[px];
  const float gw1 = gw1_in[px], gw2 = gw2_in[px], gvis = gvis_in[px];

  for (int c0 = beg; c0 < end; c0 += kStage) {
    const int n = min(kStage, end - c0);
    __syncthreads();
    if (tid < n) sf[tid] = load_face(geom, P, c0 + tid);
    __syncthreads();

    for (int b0 = 0; b0 < n; b0 += kBatch) {
      const int nb = min(kBatch, n - b0);
      for (int j = 0; j < nb; ++j) {
        const Face f = sf[b0 + j];
        float g[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // gx0 gy0 gx1 gy1 gx2 gy2
        bool active = false;
        if (!f.degen) {
          const float w0 = edge_fn(f.x1, f.y1, f.x2, f.y2, uu, vv) * f.inv_area;
          const float w1 = edge_fn(f.x2, f.y2, f.x0, f.y0, uu, vv) * f.inv_area;
          const float w2 = edge_fn(f.x0, f.y0, f.x1, f.y1, uu, vv) * f.inv_area;
          const bool inside = (w0 >= 0.f) && (w1 >= 0.f) && (w2 >= 0.f);

          float sx12, sy12, t12, sx20, sy20, t20, sx01, sy01, t01;
          const float d12 = seg_dist(f.x1, f.y1, f.x2, f.y2, uu, vv, sx12, sy12, t12);
          const float d20 = seg_dist(f.x2, f.y2, f.x0, f.y0, uu, vv, sx20, sy20, t20);
          const float d01 = seg_dist(f.x0, f.y0, f.x1, f.y1, uu, vv, sx01, sy01, t01);
          const float inner = fminf(d12, d20);
          const float dmin = fminf(inner, d01);
          const float raw = (inside ? dmin : -dmin) * csig + 0.5f;
          const float cov = fminf(fmaxf(raw, 0.f), kCovCap);

          const bool winner = (win_slot == c0 - beg + b0 + j);
          const float gw1c = winner ? gw1 : 0.f;
          const float gw2c = winner ? gw2 : 0.f;
          // d vis / d cov_f = -prod_{g != f}(1 - cov_g) = -vis / (1 - cov_f)
          float gcov = gvis * (-vis / (1.0f - cov));
          if (raw <= 0.f || raw >= kCovCap) gcov = 0.f;
          active = winner || (gcov != 0.f);

          if (active) {
            const float gd = gcov * csig;
            const float gdmin = inside ? gd : -gd;
            const float g_inner = (inner <= d01) ? gdmin : 0.f;
            const float g_d01 = gdmin - g_inner;
            const float g_d12 = (d12 <= d20) ? g_inner : 0.f;
            const float g_d20 = g_inner - g_d12;

            // segment (a, b): dd/da = (t-1) s/d, dd/db = -t s/d
            const float n12 = g_d12 / d12, n20 = g_d20 / d20, n01 = g_d01 / d01;
            const float a12x = n12 * sx12 * (t12 - 1.f), a12y = n12 * sy12 * (t12 - 1.f);
            const float b12x = -n12 * sx12 * t12, b12y = -n12 * sy12 * t12;
            const float a20x = n20 * sx20 * (t20 - 1.f), a20y = n20 * sy20 * (t20 - 1.f);
            const float b20x = -n20 * sx20 * t20, b20y = -n20 * sy20 * t20;
            const float a01x = n01 * sx01 * (t01 - 1.f), a01y = n01 * sy01 * (t01 - 1.f);
            const float b01x = -n01 * sx01 * t01, b01y = -n01 * sy01 * t01;

            const float de1 = gw1c * f.inv_area;
            const float de2 = gw2c * f.inv_area;
            const float garea = -(gw1c * w1 + gw2c * w2) * f.inv_area;

            // edge e(a, b): de/da = (by - vv, uu - bx); de/db = (vv - ay, ax - uu)
            g[0] = de1 * (vv - f.y2) + de2 * (f.y1 - vv) + garea * (f.y1 - f.y2) + a01x + b20x;
            g[1] = de1 * (f.x2 - uu) + de2 * (uu - f.x1) + garea * (f.x2 - f.x1) + a01y + b20y;
            g[2] = de2 * (vv - f.y0) + garea * (f.y2 - f.y0) + a12x + b01x;
            g[3] = de2 * (f.x0 - uu) + garea * (f.x0 - f.x2) + a12y + b01y;
            g[4] = de1 * (f.y0 - vv) + garea * (f.y0 - f.y1) + a20x + b12x;
            g[5] = de1 * (uu - f.x0) + garea * (f.x1 - f.x0) + a20y + b12y;
          }
        }
        if (__any_sync(0xffffffffu, active)) {
#pragma unroll
          for (int c = 0; c < 6; ++c) g[c] = warp_sum(g[c]);
        }
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < 6; ++c) part[warp][j][c] = g[c];
        }
      }
      __syncthreads();
      if (tid < nb * 6) {
        const int j = tid / 6, c = tid % 6;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += part[w][j][c];
        const int col = c0 + b0 + j;
        const int row = (c / 2) * 3 + (c % 2);  // x and y of corner c/2
        dgeom[row * P + col] = sum;
      } else if (tid >= 64 && tid < 64 + nb) {
        const int col = c0 + b0 + (tid - 64);
        dgeom[2 * P + col] = 0.f;
        dgeom[5 * P + col] = 0.f;
        dgeom[8 * P + col] = 0.f;
      }
      __syncthreads();
    }
  }
}

}  // namespace

// geom [9,P] f32, tile_start [T+1] i32, slot i32 and vis, gw1, gw2, gvis f32
// [T,16,16]; dgeom [9,P] f32, every column written. Returns cudaGetLastError()
// after the launch.
extern "C" int fmh_raster_bwd(const void* geom, const void* tile_start, const void* slot,
                              const void* vis, const void* gw1, const void* gw2,
                              const void* gvis, void* dgeom, int T, int P, int tiles_x,
                              float csig, void* stream) {
  raster_bwd_kernel<<<T, raster::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(geom), static_cast<const int*>(tile_start),
      static_cast<const int*>(slot), static_cast<const float*>(vis),
      static_cast<const float*>(gw1), static_cast<const float*>(gw2),
      static_cast<const float*>(gvis), static_cast<float*>(dgeom), P, tiles_x, csig);
  return static_cast<int>(cudaGetLastError());
}
