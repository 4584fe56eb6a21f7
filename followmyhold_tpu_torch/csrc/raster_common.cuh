// Per-face, per-pixel screen-space math and the chunk plan shared by the
// rasterizer's forward and backward kernels. It repeats `_face_geometry` of
// followmyhold_tpu/ops/rasterizer.py operation for operation, and the two
// sources are compiled with -fmad=false, so a pixel's barycentrics, depth and
// coverage come out bit for bit as the plain PyTorch version computes them:
// the depth test then picks the same winner on both sides.
#pragma once

#include <cuda_runtime.h>

namespace raster {

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;  // one thread per pixel of the tile
constexpr int kWarps = kThreads / 32;      // a warp covers two rows of the tile
constexpr int kChunk = 64;                 // slots of a tile's list one block takes
constexpr float kCovCap = 1.0f - 1e-3f;    // keeps d(vis)/d(cov) finite

// A face as staged in shared memory: nine screen coordinates (x, y, z of the
// three corners), 1/area, whether the face is degenerate, and its bounding box
// padded by the reach (2 sigma + 1 px): a pixel outside it has coverage 0 and
// is not inside the face, so the pair is skipped.
struct Face {
  float x0, y0, z0, x1, y1, z1, x2, y2, z2;
  float inv_area;
  float xlo, xhi, ylo, yhi;
  bool degen;
};

__device__ __forceinline__ Face load_face(const float* __restrict__ geom, int P, int col,
                                          float reach) {
  Face f;
  f.x0 = geom[0 * P + col]; f.y0 = geom[1 * P + col]; f.z0 = geom[2 * P + col];
  f.x1 = geom[3 * P + col]; f.y1 = geom[4 * P + col]; f.z1 = geom[5 * P + col];
  f.x2 = geom[6 * P + col]; f.y2 = geom[7 * P + col]; f.z2 = geom[8 * P + col];
  const float area = (f.x1 - f.x0) * (f.y2 - f.y0) - (f.y1 - f.y0) * (f.x2 - f.x0);
  f.degen = fabsf(area) < 1e-12f;
  f.inv_area = 1.0f / (f.degen ? 1.0f : area);
  f.xlo = fminf(fminf(f.x0, f.x1), f.x2) - reach;
  f.xhi = fmaxf(fmaxf(f.x0, f.x1), f.x2) + reach;
  f.ylo = fminf(fminf(f.y0, f.y1), f.y2) - reach;
  f.yhi = fmaxf(fmaxf(f.y0, f.y1), f.y2) + reach;
  return f;
}

// The plain version's test, comparison for comparison.
__device__ __forceinline__ bool in_reach(const Face& f, float uu, float vv) {
  return uu >= f.xlo && uu <= f.xhi && vv >= f.ylo && vv <= f.yhi;
}

__device__ __forceinline__ float edge_fn(float ax, float ay, float bx, float by, float uu,
                                         float vv) {
  return (bx - ax) * (vv - ay) - (by - ay) * (uu - ax);
}

// Squared distance (+1e-12, as the plain version) from the pixel to the
// segment (a, b); also the offset (sx, sy) from the nearest point of the
// segment to the pixel and that point's parameter t.
__device__ __forceinline__ float seg_dist2(float ax, float ay, float bx, float by, float uu,
                                           float vv, float& sx, float& sy, float& t) {
  const float abx = bx - ax, aby = by - ay;
  const float len2 = fmaxf(abx * abx + aby * aby, 1e-12f);
  const float apx = uu - ax, apy = vv - ay;
  t = fminf(fmaxf((apx * abx + apy * aby) / len2, 0.0f), 1.0f);
  sx = apx - t * abx;
  sy = apy - t * aby;
  return sx * sx + sy * sy + 1e-12f;
}

// The chunk plan (ops/rasterizer.py raster_chunk_plan): tile t owns chunks
// chunk_start[t] .. chunk_start[t+1]-1, at least one, so chunk_start is
// strictly increasing. The tile of chunk b is the last t with
// chunk_start[t] <= b.
__device__ __forceinline__ int find_tile(const int* __restrict__ chunk_start, int T, int b) {
  int lo = 0, hi = T - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (chunk_start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

}  // namespace raster
