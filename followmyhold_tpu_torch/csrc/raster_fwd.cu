// Tiled rasterizer, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_raster_fwd_kernel` (built by `_raster_tiles_pallas`)
// in followmyhold_tpu/ops/rasterizer.py: for every pixel of a tile, walk the
// tile's binned faces in ascending face id; the first face with a strictly
// smaller depth inside (znear, zfar) wins and leaves its slot and its
// barycentrics w1, w2; every non-degenerate face folds its soft coverage
// (signed distance to the nearest edge segment, scaled and clipped to
// [0, 1-1e-3]) into a visibility product. Both windings are drawn.
//
// What bounds it on this card: operations, in f32 outside the tensor cores.
// A (pixel, face) pair costs some 130 f32 operations against 36 bytes of
// geometry that a whole tile of 256 pixels shares.
//
// What the design does about it. The TPU tile was 128x128 because of its lane
// width, which makes the per-tile lists long; here a tile is 16x16 pixels, one
// thread per pixel, one block per tile, so a pixel only meets the faces whose
// padded bounding box touches its 16x16 neighbourhood. A tile's faces are packed
// contiguously (`tile_start[T+1]` into `geom[9, P]`, no padding to a capacity),
// staged through shared memory 256 at a time with the per-face area computed
// once at staging, and each thread keeps best depth, slot, w1, w2 and the
// visibility product in registers. Depth and normal interpolation stay outside,
// as gathers on the winner ids.

#include "raster_common.cuh"

namespace {

using namespace raster;

__global__ void __launch_bounds__(kThreads)
raster_fwd_kernel(const float* __restrict__ geom, const int* __restrict__ tile_start,
                  float* __restrict__ w1_out, float* __restrict__ w2_out,
                  int* __restrict__ slot_out, float* __restrict__ vis_out, int P, int tiles_x,
                  float csig, float znear, float zfar) {
  __shared__ Face sf[kStage];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float uu = static_cast<float>((tile % tiles_x) * kTileW + tid % kTileW);
  const float vv = static_cast<float>((tile / tiles_x) * kTileH + tid / kTileW);
  const int beg = tile_start[tile], end = tile_start[tile + 1];

  float best_z = 3.0e38f, best_w1 = 0.f, best_w2 = 0.f, vis = 1.f;
  int best_slot = -1;

  for (int c0 = beg; c0 < end; c0 += kStage) {
    const int n = min(kStage, end - c0);
    __syncthreads();
    if (tid < n) sf[tid] = load_face(geom, P, c0 + tid);
    __syncthreads();

    for (int i = 0; i < n; ++i) {
      const Face f = sf[i];
      if (f.degen) continue;  // no hit and no coverage
      const float w0 = edge_fn(f.x1, f.y1, f.x2, f.y2, uu, vv) * f.inv_area;
      const float w1 = edge_fn(f.x2, f.y2, f.x0, f.y0, uu, vv) * f.inv_area;
      const float w2 = edge_fn(f.x0, f.y0, f.x1, f.y1, uu, vv) * f.inv_area;
      const float zpix = w0 * f.z0 + w1 * f.z1 + w2 * f.z2;
      const bool inside = (w0 >= 0.f) && (w1 >= 0.f) && (w2 >= 0.f);

      float sx, sy, t;
      const float d12 = seg_dist(f.x1, f.y1, f.x2, f.y2, uu, vv, sx, sy, t);
      const float d20 = seg_dist(f.x2, f.y2, f.x0, f.y0, uu, vv, sx, sy, t);
      const float d01 = seg_dist(f.x0, f.y0, f.x1, f.y1, uu, vv, sx, sy, t);
      const float dmin = fminf(fminf(d12, d20), d01);
      const float raw = (inside ? dmin : -dmin) * csig + 0.5f;
      const float cov = fminf(fmaxf(raw, 0.f), kCovCap);

      if (inside && zpix > znear && zpix < zfar && zpix < best_z) {
        best_z = zpix;
        best_slot = c0 - beg + i;
        best_w1 = w1;
        best_w2 = w2;
      }
      vis = vis * (1.0f - cov);
    }
  }

  const int out = tile * kThreads + tid;
  w1_out[out] = best_w1;
  w2_out[out] = best_w2;
  slot_out[out] = best_slot;
  vis_out[out] = vis;
}

}  // namespace

// geom [9,P] f32, tile_start [T+1] i32; w1, w2, vis f32 and slot i32 [T,16,16].
// Returns cudaGetLastError() after the launch.
extern "C" int fmh_raster_fwd(const void* geom, const void* tile_start, void* w1, void* w2,
                              void* slot, void* vis, int T, int P, int tiles_x, float csig,
                              float znear, float zfar, void* stream) {
  raster_fwd_kernel<<<T, raster::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(geom), static_cast<const int*>(tile_start),
      static_cast<float*>(w1), static_cast<float*>(w2), static_cast<int*>(slot),
      static_cast<float*>(vis), P, tiles_x, csig, znear, zfar);
  return static_cast<int>(cudaGetLastError());
}
