// Per-face, per-pixel screen-space math shared by the rasterizer's forward and
// backward kernels. It repeats `_face_geometry` of
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
constexpr int kStage = 256;                // faces staged in shared memory at a time
constexpr float kCovCap = 1.0f - 1e-3f;    // keeps d(vis)/d(cov) finite

// A face as staged in shared memory: nine screen coordinates (x, y, z of the
// three corners), 1/area, and whether the face is degenerate.
struct Face {
  float x0, y0, z0, x1, y1, z1, x2, y2, z2;
  float inv_area;
  bool degen;
};

__device__ __forceinline__ Face load_face(const float* __restrict__ geom, int P, int col) {
  Face f;
  f.x0 = geom[0 * P + col]; f.y0 = geom[1 * P + col]; f.z0 = geom[2 * P + col];
  f.x1 = geom[3 * P + col]; f.y1 = geom[4 * P + col]; f.z1 = geom[5 * P + col];
  f.x2 = geom[6 * P + col]; f.y2 = geom[7 * P + col]; f.z2 = geom[8 * P + col];
  const float area = (f.x1 - f.x0) * (f.y2 - f.y0) - (f.y1 - f.y0) * (f.x2 - f.x0);
  f.degen = fabsf(area) < 1e-12f;
  f.inv_area = 1.0f / (f.degen ? 1.0f : area);
  return f;
}

__device__ __forceinline__ float edge_fn(float ax, float ay, float bx, float by, float uu,
                                         float vv) {
  return (bx - ax) * (vv - ay) - (by - ay) * (uu - ax);
}

// Distance from the pixel to the segment (a, b); also the offset (sx, sy) from
// the nearest point of the segment to the pixel and that point's parameter t.
__device__ __forceinline__ float seg_dist(float ax, float ay, float bx, float by, float uu,
                                          float vv, float& sx, float& sy, float& t) {
  const float abx = bx - ax, aby = by - ay;
  const float len2 = fmaxf(abx * abx + aby * aby, 1e-12f);
  const float apx = uu - ax, apy = vv - ay;
  t = fminf(fmaxf((apx * abx + apy * aby) / len2, 0.0f), 1.0f);
  sx = apx - t * abx;
  sy = apy - t * aby;
  return sqrtf(sx * sx + sy * sy + 1e-12f);
}

}  // namespace raster
