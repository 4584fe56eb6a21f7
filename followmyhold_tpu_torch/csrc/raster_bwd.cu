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
// What bounds it on this card: operations in f32, some 170 a (pixel, face)
// pair within the face's reach, as in the forward, plus a sum of six numbers
// a face over those pixels.
//
// What the design does about it.
// - The forward's chunk plan: one block a chunk of at most kChunk consecutive
//   slots of one tile's list, so a dense tile's list is spread over many
//   blocks. A block owns the `dgeom[9, P]` columns of its chunk, so each
//   column has exactly one writer: no atomics, no merge, and the result does
//   not change from run to run.
// - The tile's per-pixel inputs are staged once in shared memory; after that
//   the block never synchronises. Each warp takes its own faces of the chunk
//   (face j goes to warp j % 8) and walks only the pixels of the tile inside
//   the face's padded bounding box, its lanes on consecutive pixels; the six
//   sums are taken by warp shuffles in a fixed order. Pixels beyond the reach
//   have coverage 0 and no win, so they would add exact zeros.
// - Every column is written, zeros for a face that no pixel reaches: the
//   wrapper allocates dgeom uninitialised.
// - Several images go in one launch, as in the forward: a tile's pixel
//   origin comes from its index within its image, and each column still
//   belongs to one tile of one image, so its one writer sums what the image's
//   own launch sums, in the same order.

#include "raster_common.cuh"

namespace {

using namespace raster;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
raster_bwd_chunk_kernel(const float* __restrict__ geom, const int* __restrict__ tile_start,
                        const int* __restrict__ chunk_start, const int* __restrict__ slot_in,
                        const float* __restrict__ vis_in, const float* __restrict__ gw1_in,
                        const float* __restrict__ gw2_in, const float* __restrict__ gvis_in,
                        float* __restrict__ dgeom, int T, int P, int tiles_x,
                        int tiles_per_image, float csig, float reach) {
  __shared__ Face sf[kChunk];
  __shared__ int s_slot[kThreads];
  __shared__ float s_vis[kThreads], s_gw1[kThreads], s_gw2[kThreads], s_gvis[kThreads];

  const int b = blockIdx.x;
  if (b >= chunk_start[T]) return;  // the grid is sized by a host-known bound
  const int tile = find_tile(chunk_start, T, b);
  const int first = (b - chunk_start[tile]) * kChunk;  // first slot of the chunk
  const int beg = tile_start[tile] + first;
  const int n = min(kChunk, tile_start[tile + 1] - beg);
  if (n <= 0) return;  // an empty tile's chunk owns no column

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int local = tile % tiles_per_image;  // the tile's index within its image
  const int tile_x0 = (local % tiles_x) * kTileW, tile_y0 = (local / tiles_x) * kTileH;
  const float fx0 = static_cast<float>(tile_x0), fy0 = static_cast<float>(tile_y0);

  if (tid < n) sf[tid] = load_face(geom, P, beg + tid, reach);
  const int px_in = tile * kThreads + tid;
  s_slot[tid] = slot_in[px_in];
  s_vis[tid] = vis_in[px_in];
  s_gw1[tid] = gw1_in[px_in];
  s_gw2[tid] = gw2_in[px_in];
  s_gvis[tid] = gvis_in[px_in];
  __syncthreads();

  for (int j = warp; j < n; j += kWarps) {
    const Face& f = sf[j];
    float g[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // gx0 gy0 gx1 gy1 gx2 gy2
    // the tile's pixels inside the padded box: uu >= xlo <=> uu >= ceil(xlo)
    const float cx_lo = fmaxf(ceilf(f.xlo) - fx0, 0.f);
    const float cx_hi = fminf(floorf(f.xhi) - fx0, static_cast<float>(kTileW - 1));
    const float cy_lo = fmaxf(ceilf(f.ylo) - fy0, 0.f);
    const float cy_hi = fminf(floorf(f.yhi) - fy0, static_cast<float>(kTileH - 1));
    if (!f.degen && cx_lo <= cx_hi && cy_lo <= cy_hi) {
      const int rx = static_cast<int>(cx_lo), ry = static_cast<int>(cy_lo);
      const int rw = static_cast<int>(cx_hi) - rx + 1;
      const int rn = rw * (static_cast<int>(cy_hi) - ry + 1);
      const int my_slot = first + j;
      for (int p = lane; p < rn; p += 32) {
        const int lx = rx + p % rw, ly = ry + p / rw;
        const int pix = ly * kTileW + lx;
        const float uu = fx0 + static_cast<float>(lx);
        const float vv = fy0 + static_cast<float>(ly);
        if (!in_reach(f, uu, vv)) continue;  // the plain version's comparisons

        const float w0 = edge_fn(f.x1, f.y1, f.x2, f.y2, uu, vv) * f.inv_area;
        const float w1 = edge_fn(f.x2, f.y2, f.x0, f.y0, uu, vv) * f.inv_area;
        const float w2 = edge_fn(f.x0, f.y0, f.x1, f.y1, uu, vv) * f.inv_area;
        const bool inside = (w0 >= 0.f) && (w1 >= 0.f) && (w2 >= 0.f);

        float sx12, sy12, t12, sx20, sy20, t20, sx01, sy01, t01;
        const float d12 = sqrtf(seg_dist2(f.x1, f.y1, f.x2, f.y2, uu, vv, sx12, sy12, t12));
        const float d20 = sqrtf(seg_dist2(f.x2, f.y2, f.x0, f.y0, uu, vv, sx20, sy20, t20));
        const float d01 = sqrtf(seg_dist2(f.x0, f.y0, f.x1, f.y1, uu, vv, sx01, sy01, t01));
        const float inner = fminf(d12, d20);
        const float dmin = fminf(inner, d01);
        const float raw = (inside ? dmin : -dmin) * csig + 0.5f;
        const float cov = fminf(fmaxf(raw, 0.f), kCovCap);

        const bool winner = (s_slot[pix] == my_slot);
        const float gw1c = winner ? s_gw1[pix] : 0.f;
        const float gw2c = winner ? s_gw2[pix] : 0.f;
        // d vis / d cov_f = -prod_{g != f}(1 - cov_g) = -vis / (1 - cov_f)
        float gcov = s_gvis[pix] * (-s_vis[pix] / (1.0f - cov));
        if (raw <= 0.f || raw >= kCovCap) gcov = 0.f;
        if (!winner && gcov == 0.f) continue;

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
        g[0] += de1 * (vv - f.y2) + de2 * (f.y1 - vv) + garea * (f.y1 - f.y2) + a01x + b20x;
        g[1] += de1 * (f.x2 - uu) + de2 * (uu - f.x1) + garea * (f.x2 - f.x1) + a01y + b20y;
        g[2] += de2 * (vv - f.y0) + garea * (f.y2 - f.y0) + a12x + b01x;
        g[3] += de2 * (f.x0 - uu) + garea * (f.x0 - f.x2) + a12y + b01y;
        g[4] += de1 * (f.y0 - vv) + garea * (f.y0 - f.y1) + a20x + b12x;
        g[5] += de1 * (uu - f.x0) + garea * (f.x1 - f.x0) + a20y + b12y;
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) g[c] = warp_sum(g[c]);
    const int col = beg + j;
    // lanes 0-5 write x and y of corner c/2, lanes 6-8 the z rows
    if (lane < 6) {
      float v = g[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) v = (lane == c) ? g[c] : v;
      dgeom[((lane / 2) * 3 + (lane % 2)) * P + col] = v;
    } else if (lane < 9) {
      dgeom[((lane - 6) * 3 + 2) * P + col] = 0.f;
    }
  }
}

}  // namespace

// geom [9,P] f32, tile_start [T+1] i32, chunk_start [T+1] i32 (the forward's
// chunk plan), slot i32 and vis, gw1, gw2, gvis f32 [T,16,16]; dgeom [9,P]
// f32, every column written. The T tiles are T / tiles_per_image images' in
// turn, as in fmh_raster_fwd. n_grid >= chunk_start[T]; `chunk` must be
// kChunk. Returns cudaGetLastError() after the launch.
extern "C" int fmh_raster_bwd(const void* geom, const void* tile_start, const void* chunk_start,
                              const void* slot, const void* vis, const void* gw1,
                              const void* gw2, const void* gvis, void* dgeom, int T, int P,
                              int tiles_x, int tiles_per_image, int n_grid, int chunk,
                              float csig, float reach, void* stream) {
  if (chunk != raster::kChunk || T < 1 || n_grid < T || tiles_per_image < 1 ||
      T % tiles_per_image || tiles_per_image % tiles_x) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  raster_bwd_chunk_kernel<<<n_grid, raster::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(geom), static_cast<const int*>(tile_start),
      static_cast<const int*>(chunk_start), static_cast<const int*>(slot),
      static_cast<const float*>(vis), static_cast<const float*>(gw1),
      static_cast<const float*>(gw2), static_cast<const float*>(gvis),
      static_cast<float*>(dgeom), T, P, tiles_x, tiles_per_image, csig, reach);
  return static_cast<int>(cudaGetLastError());
}
