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
// A (pixel, face) pair within the face's reach costs some 80 f32 operations
// against 36 bytes of geometry that a whole tile of 256 pixels shares.
//
// What the design does about it.
// - A tile is 16x16 pixels, one thread a pixel. A tile's faces are packed
//   contiguously (`tile_start[T+1]` into `geom[9, P]`).
// - Several images go in one launch: their tile lists join image-major, each
//   image's `tiles_per_image` tiles after the last one's, over their geometry
//   concatenated. A tile finds its pixel origin from its index within its
//   image, so each image's outputs are those of its launch alone, bit for bit.
//   The plan and the merge read no pixel position: they run over the joined
//   list as over one image's, a plan's chunk numbers running on across images.
// - The unit of work is a chunk of at most kChunk consecutive slots of one
//   tile's list (`chunk_start`, the plan that `chunk_plan_kernel` below builds
//   on the device, as ops/rasterizer.py raster_chunk_plan_plain states it),
//   one block a chunk. A dense tile's
//   long list is spread over many blocks and SMs instead of one block walking
//   it serially. A tile with one chunk, most of them, writes its outputs
//   directly. The chunks of a longer tile leave partial results (first
//   strictly nearest hit, partial visibility product) that a second launch
//   merges in chunk order: a later chunk wins only with a strictly smaller
//   depth, and the partial products are multiplied in order, so the result
//   does not depend on which block finished first.
// - Pairs beyond the face's reach are skipped (see raster_common.cuh). A warp
//   covers an 8x4 block of the tile and skips, as a whole, a face whose padded
//   box misses the block, the usual case for a small face.
// - One square root of the least squared distance instead of three: a
//   correctly rounded square root is monotone, so it is the same number.

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr float kBig = 3.0e38f;
constexpr int kBlockW = 8, kBlockH = 4;  // a warp's pixels
static_assert(kWarps == (kTileW / kBlockW) * (kTileH / kBlockH), "8 warps tile 16x16");

__global__ void __launch_bounds__(kThreads)
raster_fwd_chunk_kernel(const float* __restrict__ geom, const int* __restrict__ tile_start,
                        const int* __restrict__ chunk_start, float* __restrict__ w1_out,
                        float* __restrict__ w2_out, int* __restrict__ slot_out,
                        float* __restrict__ vis_out, float* __restrict__ scratch, int T, int P,
                        int tiles_x, int tiles_per_image, int n_grid, float csig, float reach,
                        float znear, float zfar) {
  __shared__ Face sf[kChunk];

  const int b = blockIdx.x;
  if (b >= chunk_start[T]) return;  // the grid is sized by a host-known bound
  const int tile = find_tile(chunk_start, T, b);
  const int first = (b - chunk_start[tile]) * kChunk;  // first slot of the chunk
  const int beg = tile_start[tile] + first;
  const int n = max(0, min(kChunk, tile_start[tile + 1] - beg));
  const bool alone = chunk_start[tile + 1] - chunk_start[tile] == 1;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // warp w covers the 8x4 block (w % 2, w / 2) of the tile, lane l its pixel
  // (l % 8, l / 8)
  const int lx = (warp & 1) * kBlockW + (lane % kBlockW);
  const int ly = (warp >> 1) * kBlockH + (lane / kBlockW);
  const int local = tile % tiles_per_image;  // the tile's index within its image
  const float col_lo = static_cast<float>((local % tiles_x) * kTileW + (warp & 1) * kBlockW);
  const float row_lo = static_cast<float>((local / tiles_x) * kTileH + (warp >> 1) * kBlockH);
  const float col_hi = col_lo + static_cast<float>(kBlockW - 1);
  const float row_hi = row_lo + static_cast<float>(kBlockH - 1);
  const float uu = col_lo + static_cast<float>(lane % kBlockW);
  const float vv = row_lo + static_cast<float>(lane / kBlockW);
  const int pix = ly * kTileW + lx;

  if (tid < n) sf[tid] = load_face(geom, P, beg + tid, reach);
  __syncthreads();

  float best_z = kBig, best_w1 = 0.f, best_w2 = 0.f, vis = 1.f;
  int best_slot = -1;
  for (int i = 0; i < n; ++i) {
    const Face& f = sf[i];
    if (f.degen || row_hi < f.ylo || row_lo > f.yhi || col_hi < f.xlo || col_lo > f.xhi) {
      continue;  // warp-uniform
    }
    if (!in_reach(f, uu, vv)) continue;
    const float w0 = edge_fn(f.x1, f.y1, f.x2, f.y2, uu, vv) * f.inv_area;
    const float w1 = edge_fn(f.x2, f.y2, f.x0, f.y0, uu, vv) * f.inv_area;
    const float w2 = edge_fn(f.x0, f.y0, f.x1, f.y1, uu, vv) * f.inv_area;
    const float zpix = w0 * f.z0 + w1 * f.z1 + w2 * f.z2;
    const bool inside = (w0 >= 0.f) && (w1 >= 0.f) && (w2 >= 0.f);

    float sx, sy, t;
    const float q12 = seg_dist2(f.x1, f.y1, f.x2, f.y2, uu, vv, sx, sy, t);
    const float q20 = seg_dist2(f.x2, f.y2, f.x0, f.y0, uu, vv, sx, sy, t);
    const float q01 = seg_dist2(f.x0, f.y0, f.x1, f.y1, uu, vv, sx, sy, t);
    const float dmin = sqrtf(fminf(fminf(q12, q20), q01));
    const float raw = (inside ? dmin : -dmin) * csig + 0.5f;
    const float cov = fminf(fmaxf(raw, 0.f), kCovCap);

    if (inside && zpix > znear && zpix < zfar && zpix < best_z) {
      best_z = zpix;
      best_slot = first + i;
      best_w1 = w1;
      best_w2 = w2;
    }
    vis = vis * (1.0f - cov);
  }

  if (alone) {
    const int out = tile * kThreads + pix;
    w1_out[out] = best_w1;
    w2_out[out] = best_w2;
    slot_out[out] = best_slot;
    vis_out[out] = vis;
  } else {
    // scratch [5, n_grid, 256]: z, w1, w2, vis, slot (as int bits)
    const size_t plane = static_cast<size_t>(n_grid) * kThreads;
    const size_t at = static_cast<size_t>(b) * kThreads + pix;
    scratch[at] = best_z;
    scratch[plane + at] = best_w1;
    scratch[2 * plane + at] = best_w2;
    scratch[3 * plane + at] = vis;
    reinterpret_cast<int*>(scratch)[4 * plane + at] = best_slot;
  }
}

// One block a tile; only tiles with more than one chunk have work.
__global__ void __launch_bounds__(kThreads)
raster_fwd_merge_kernel(const int* __restrict__ chunk_start, float* __restrict__ w1_out,
                        float* __restrict__ w2_out, int* __restrict__ slot_out,
                        float* __restrict__ vis_out, const float* __restrict__ scratch,
                        int n_grid) {
  const int tile = blockIdx.x;
  const int c_beg = chunk_start[tile], c_end = chunk_start[tile + 1];
  if (c_end - c_beg < 2) return;
  const int tid = threadIdx.x;
  const size_t plane = static_cast<size_t>(n_grid) * kThreads;
  float best_z = kBig, best_w1 = 0.f, best_w2 = 0.f, vis = 1.f;
  int best_slot = -1;
  for (int c = c_beg; c < c_end; ++c) {
    const size_t at = static_cast<size_t>(c) * kThreads + tid;
    const float z = scratch[at];
    if (z < best_z) {
      best_z = z;
      best_w1 = scratch[plane + at];
      best_w2 = scratch[2 * plane + at];
      best_slot = reinterpret_cast<const int*>(scratch)[4 * plane + at];
    }
    vis = vis * scratch[3 * plane + at];
  }
  const int out = tile * kThreads + tid;
  w1_out[out] = best_w1;
  w2_out[out] = best_w2;
  slot_out[out] = best_slot;
  vis_out[out] = vis;
}

// The chunk plan, one block: chunk_start[0] = 0 and chunk_start[t+1] =
// chunk_start[t] + max(1, ceil(count_t / kChunk)), an inclusive scan over the
// tiles kPlanThreads at a time (warp shuffles, then the warps' totals).
constexpr int kPlanThreads = 1024;

__global__ void __launch_bounds__(kPlanThreads)
chunk_plan_kernel(const int* __restrict__ tile_start, int T, int* __restrict__ chunk_start) {
  __shared__ int warp_total[kPlanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) chunk_start[0] = 0;
  int carry = 0;  // chunks of the tiles before this round
  for (int base = 0; base < T; base += kPlanThreads) {
    const int t = base + tid;
    int x = 0;
    if (t < T) x = max(1, (tile_start[t + 1] - tile_start[t] + kChunk - 1) / kChunk);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_total[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_total[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      warp_total[lane] = w;
    }
    __syncthreads();
    if (t < T) chunk_start[t + 1] = carry + (warp > 0 ? warp_total[warp - 1] : 0) + x;
    carry += warp_total[kPlanThreads / 32 - 1];
    __syncthreads();  // warp_total is rewritten by the next round
  }
}

}  // namespace

// tile_start [T+1] i32 -> chunk_start [T+1] i32, the chunk plan of the
// forward and backward kernels. `chunk` must be kChunk. Returns
// cudaGetLastError() after the launch.
extern "C" int fmh_raster_chunk_plan(const void* tile_start, void* chunk_start, int T, int chunk,
                                     void* stream) {
  if (chunk != raster::kChunk || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  chunk_plan_kernel<<<1, kPlanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_start), T, static_cast<int*>(chunk_start));
  return static_cast<int>(cudaGetLastError());
}

// geom [9,P] f32, tile_start [T+1] i32, chunk_start [T+1] i32 (the chunk
// plan); w1, w2, vis f32 and slot i32 [T,16,16]; scratch f32 [5, n_grid, 256]
// where n_grid >= chunk_start[T]. The T tiles are T / tiles_per_image images'
// in turn, each tiles_x wide. `chunk` must be kChunk. Launches the chunk
// kernel and the merge, returns cudaGetLastError() after them.
extern "C" int fmh_raster_fwd(const void* geom, const void* tile_start, const void* chunk_start,
                              void* w1, void* w2, void* slot, void* vis, void* scratch, int T,
                              int P, int tiles_x, int tiles_per_image, int n_grid, int chunk,
                              float csig, float reach, float znear, float zfar, void* stream) {
  if (chunk != raster::kChunk || T < 1 || n_grid < T || tiles_per_image < 1 ||
      T % tiles_per_image || tiles_per_image % tiles_x) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  raster_fwd_chunk_kernel<<<n_grid, raster::kThreads, 0, s>>>(
      static_cast<const float*>(geom), static_cast<const int*>(tile_start),
      static_cast<const int*>(chunk_start), static_cast<float*>(w1), static_cast<float*>(w2),
      static_cast<int*>(slot), static_cast<float*>(vis), static_cast<float*>(scratch), T, P,
      tiles_x, tiles_per_image, n_grid, csig, reach, znear, zfar);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  raster_fwd_merge_kernel<<<T, raster::kThreads, 0, s>>>(
      static_cast<const int*>(chunk_start), static_cast<float*>(w1), static_cast<float*>(w2),
      static_cast<int*>(slot), static_cast<float*>(vis), static_cast<const float*>(scratch),
      n_grid);
  return static_cast<int>(cudaGetLastError());
}
