// Native host-side mesh operations of the PyTorch port.
//
// A copy of the JAX package's followmyhold_tpu/native/mesh_ops.cpp (the port
// imports nothing of that package). It is host code, not a GPU kernel: the
// export's marching-tets emission and the mesh post-processing (connected
// components for the floater removal, compaction, grid and quadric
// decimation for the face reduction) over 10^5..10^6-element meshes.
//
// Built with g++ at first use into build/ beside the package and loaded via
// ctypes by followmyhold_tpu_torch/native/__init__.py, which raises when the
// build fails: nothing falls back quietly. The NumPy versions in
// followmyhold_tpu_torch/geometry/postprocess.py and ops/surface.py are the
// plain versions the tests hold these functions against.
//
// decimate_quadric assumes a closed (watertight) input: it adds no boundary
// quadrics, so an open boundary may shrink as its edges collapse. The
// marching-tets export is closed wherever it stays inside the decode box.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" {

// Union-find with path halving.
static int32_t uf_find(int32_t* parent, int32_t a) {
  while (parent[a] != a) {
    parent[a] = parent[parent[a]];
    a = parent[a];
  }
  return a;
}

// Label connected components over face edges.
// verts: n_verts, faces: [n_faces, 3] int32. out_labels: [n_verts] int32.
// Returns the label of the largest component.
int32_t connected_components(int32_t n_verts, int32_t n_faces,
                             const int32_t* faces, int32_t* out_labels) {
  std::vector<int32_t> parent(n_verts);
  for (int32_t i = 0; i < n_verts; ++i) parent[i] = i;

  for (int32_t f = 0; f < n_faces; ++f) {
    int32_t a = uf_find(parent.data(), faces[3 * f]);
    int32_t b = uf_find(parent.data(), faces[3 * f + 1]);
    int32_t c = uf_find(parent.data(), faces[3 * f + 2]);
    if (b != a) parent[b] = a;
    if (c != a) parent[uf_find(parent.data(), c)] = a;
  }

  std::vector<int64_t> count(n_verts, 0);
  for (int32_t i = 0; i < n_verts; ++i) {
    out_labels[i] = uf_find(parent.data(), i);
    count[out_labels[i]]++;
  }
  int32_t best = 0;
  int64_t best_count = -1;
  for (int32_t i = 0; i < n_verts; ++i) {
    if (count[i] > best_count) {
      best_count = count[i];
      best = i;
    }
  }
  return best;
}

// Compact a mesh to the vertices with keep[i] != 0, dropping faces touching
// removed vertices. Returns new face count; writes remapped faces and the
// vertex remap (-1 for dropped).
int32_t compact_mesh(int32_t n_verts, int32_t n_faces, const int32_t* faces,
                     const uint8_t* keep, int32_t* out_faces,
                     int32_t* out_remap) {
  int32_t nv = 0;
  for (int32_t i = 0; i < n_verts; ++i)
    out_remap[i] = keep[i] ? nv++ : -1;

  int32_t nf = 0;
  for (int32_t f = 0; f < n_faces; ++f) {
    int32_t a = out_remap[faces[3 * f]];
    int32_t b = out_remap[faces[3 * f + 1]];
    int32_t c = out_remap[faces[3 * f + 2]];
    if (a >= 0 && b >= 0 && c >= 0) {
      out_faces[3 * nf] = a;
      out_faces[3 * nf + 1] = b;
      out_faces[3 * nf + 2] = c;
      nf++;
    }
  }
  return nf;
}

// Grid-cluster decimation: assign each vertex to a grid cell of size `cell`,
// average positions per cell, remap faces, drop degenerates and duplicates.
// Returns new face count; n_out_verts written through.
int32_t decimate_grid(int32_t n_verts, int32_t n_faces, const float* verts,
                      const int32_t* faces, float cell, float lo_x, float lo_y,
                      float lo_z, float* out_verts, int32_t* out_faces,
                      int32_t* n_out_verts) {
  std::unordered_map<int64_t, int32_t> cell_id;
  cell_id.reserve(n_verts * 2);
  std::vector<int32_t> remap(n_verts);
  std::vector<double> acc;
  std::vector<int32_t> cnt;

  const double inv = 1.0 / (cell > 1e-12f ? cell : 1e-12f);
  for (int32_t i = 0; i < n_verts; ++i) {
    int64_t gx = (int64_t)((verts[3 * i] - lo_x) * inv);
    int64_t gy = (int64_t)((verts[3 * i + 1] - lo_y) * inv);
    int64_t gz = (int64_t)((verts[3 * i + 2] - lo_z) * inv);
    int64_t key = (gx * 73856093LL) ^ (gy * 19349663LL) ^ (gz * 83492791LL);
    auto it = cell_id.find(key);
    int32_t id;
    if (it == cell_id.end()) {
      id = (int32_t)cnt.size();
      cell_id.emplace(key, id);
      acc.resize(acc.size() + 3, 0.0);
      cnt.push_back(0);
    } else {
      id = it->second;
    }
    remap[i] = id;
    acc[3 * id] += verts[3 * i];
    acc[3 * id + 1] += verts[3 * i + 1];
    acc[3 * id + 2] += verts[3 * i + 2];
    cnt[id]++;
  }

  int32_t nv = (int32_t)cnt.size();
  for (int32_t i = 0; i < nv; ++i) {
    out_verts[3 * i] = (float)(acc[3 * i] / cnt[i]);
    out_verts[3 * i + 1] = (float)(acc[3 * i + 1] / cnt[i]);
    out_verts[3 * i + 2] = (float)(acc[3 * i + 2] / cnt[i]);
  }
  *n_out_verts = nv;

  std::unordered_map<int64_t, bool> seen;
  seen.reserve(n_faces * 2);
  int32_t nf = 0;
  for (int32_t f = 0; f < n_faces; ++f) {
    int32_t a = remap[faces[3 * f]];
    int32_t b = remap[faces[3 * f + 1]];
    int32_t c = remap[faces[3 * f + 2]];
    if (a == b || b == c || a == c) continue;
    // canonical key for dedup (sorted)
    int32_t s0 = a < b ? (a < c ? a : c) : (b < c ? b : c);
    int32_t s2 = a > b ? (a > c ? a : c) : (b > c ? b : c);
    int32_t s1 = a + b + c - s0 - s2;
    int64_t key = ((int64_t)s0 << 42) | ((int64_t)s1 << 21) | (int64_t)s2;
    if (seen.count(key)) continue;
    seen.emplace(key, true);
    out_faces[3 * nf] = a;
    out_faces[3 * nf + 1] = b;
    out_faces[3 * nf + 2] = c;
    nf++;
  }
  return nf;
}

// --------------------------------------------------------------------------
// Quadric edge-collapse decimation (Garland-Heckbert error quadrics).
//
// Quality counterpart of decimate_grid for the exported meshes the
// chamfer-parity metric scores: grid clustering displaces every vertex by up
// to half a grid cell, while edge collapse moves only the vertices whose
// removal costs least (the classic FaceReducer/pymeshlab behavior). Candidate
// positions per edge are {a, b, midpoint} scored by the summed quadric — the
// "fast" GH variant (no 4x4 solve); on watertight marching-tets meshes the
// quality difference is negligible and the robustness difference is not.
// --------------------------------------------------------------------------

namespace {

// 4x4 symmetric quadric, upper-triangular storage:
// [a00,a01,a02,a03, a11,a12,a13, a22,a23, a33]
inline double qerr(const double* q, double x, double y, double z) {
  return q[0] * x * x + 2 * q[1] * x * y + 2 * q[2] * x * z + 2 * q[3] * x +
         q[4] * y * y + 2 * q[5] * y * z + 2 * q[6] * y + q[7] * z * z +
         2 * q[8] * z + q[9];
}

struct HeapEntry {
  double cost;
  int32_t a, b;      // canonical a < b, both roots when pushed
  int32_t va, vb;    // vertex versions at push time (lazy invalidation)
};
struct HeapCmp {
  bool operator()(const HeapEntry& x, const HeapEntry& y) const {
    return x.cost > y.cost;  // min-heap
  }
};

}  // namespace

// Decimate to <= target_faces by quadric edge collapse. Writes compacted
// vertices/faces; returns the new face count (>= 0) or -1 on invalid input.
// out_verts must hold n_verts*3 floats, out_faces n_faces*3 int32.
int32_t decimate_quadric(int32_t n_verts, int64_t n_faces, const float* verts,
                         const int32_t* faces, int64_t target_faces,
                         float* out_verts, int32_t* out_faces,
                         int32_t* n_out_verts) {
  if (n_verts <= 0 || n_faces <= 0 || target_faces < 0) return -1;

  std::vector<double> vpos(3 * (size_t)n_verts);
  for (int64_t i = 0; i < 3 * (int64_t)n_verts; ++i) vpos[i] = verts[i];

  // per-vertex quadric = sum of incident faces' area-weighted plane quadrics
  std::vector<double> Q((size_t)n_verts * 10, 0.0);
  std::vector<std::vector<int32_t>> vfaces(n_verts);
  std::vector<uint8_t> alive((size_t)n_faces, 1);
  for (int64_t f = 0; f < n_faces; ++f) {
    const int32_t i0 = faces[3 * f], i1 = faces[3 * f + 1],
                  i2 = faces[3 * f + 2];
    if (i0 < 0 || i1 < 0 || i2 < 0 || i0 >= n_verts || i1 >= n_verts ||
        i2 >= n_verts)
      return -1;
    const double* p0 = &vpos[3 * (size_t)i0];
    const double* p1 = &vpos[3 * (size_t)i1];
    const double* p2 = &vpos[3 * (size_t)i2];
    const double ux = p1[0] - p0[0], uy = p1[1] - p0[1], uz = p1[2] - p0[2];
    const double wx = p2[0] - p0[0], wy = p2[1] - p0[1], wz = p2[2] - p0[2];
    double nx = uy * wz - uz * wy, ny = uz * wx - ux * wz,
           nz = ux * wy - uy * wx;
    const double len = std::sqrt(nx * nx + ny * ny + nz * nz);
    const double area = 0.5 * len;
    if (len > 1e-30) {
      nx /= len;
      ny /= len;
      nz /= len;
    } else {
      nx = ny = nz = 0.0;
    }
    const double d = -(nx * p0[0] + ny * p0[1] + nz * p0[2]);
    const double k[10] = {nx * nx, nx * ny, nx * nz, nx * d, ny * ny,
                          ny * nz, ny * d,  nz * nz, nz * d, d * d};
    for (int v = 0; v < 3; ++v) {
      const int32_t vid = faces[3 * f + v];
      double* q = &Q[(size_t)vid * 10];
      for (int j = 0; j < 10; ++j) q[j] += area * k[j];
      vfaces[vid].push_back((int32_t)f);
    }
  }

  std::vector<int32_t> parent(n_verts);
  for (int32_t i = 0; i < n_verts; ++i) parent[i] = i;
  std::vector<int32_t> ver((size_t)n_verts, 0);

  std::priority_queue<HeapEntry, std::vector<HeapEntry>, HeapCmp> heap;
  auto push_edge = [&](int32_t a, int32_t b) {
    if (a == b) return;
    if (a > b) std::swap(a, b);
    const double* qa = &Q[(size_t)a * 10];
    const double* qb = &Q[(size_t)b * 10];
    double qs[10];
    for (int j = 0; j < 10; ++j) qs[j] = qa[j] + qb[j];
    const double* pa = &vpos[3 * (size_t)a];
    const double* pb = &vpos[3 * (size_t)b];
    const double mx = 0.5 * (pa[0] + pb[0]), my = 0.5 * (pa[1] + pb[1]),
                 mz = 0.5 * (pa[2] + pb[2]);
    const double ca = qerr(qs, pa[0], pa[1], pa[2]);
    const double cb = qerr(qs, pb[0], pb[1], pb[2]);
    const double cm = qerr(qs, mx, my, mz);
    double c = cm < ca ? (cm < cb ? cm : cb) : (ca < cb ? ca : cb);
    heap.push(HeapEntry{c, a, b, ver[a], ver[b]});
  };

  {
    std::unordered_set<int64_t> seen;
    seen.reserve((size_t)n_faces * 2);
    for (int64_t f = 0; f < n_faces; ++f) {
      for (int e = 0; e < 3; ++e) {
        int32_t a = faces[3 * f + e], b = faces[3 * f + (e + 1) % 3];
        if (a == b) continue;
        if (a > b) std::swap(a, b);
        const int64_t key = ((int64_t)a << 32) | (uint32_t)b;
        if (seen.insert(key).second) push_edge(a, b);
      }
    }
  }

  int64_t live_faces = 0;
  for (int64_t f = 0; f < n_faces; ++f) {
    const int32_t i0 = faces[3 * f], i1 = faces[3 * f + 1],
                  i2 = faces[3 * f + 2];
    if (i0 == i1 || i1 == i2 || i0 == i2) {
      alive[f] = 0;
    } else {
      ++live_faces;
    }
  }

  while (live_faces > target_faces && !heap.empty()) {
    const HeapEntry e = heap.top();
    heap.pop();
    // stale if either endpoint was merged away or its quadric/position moved
    if (parent[e.a] != e.a || parent[e.b] != e.b) continue;
    if (ver[e.a] != e.va || ver[e.b] != e.vb) continue;
    const int32_t a = e.a, b = e.b;

    // winning position: best of {a, b, mid} under the summed quadric
    double qs[10];
    for (int j = 0; j < 10; ++j) qs[j] = Q[(size_t)a * 10 + j] + Q[(size_t)b * 10 + j];
    const double* pa = &vpos[3 * (size_t)a];
    const double* pb = &vpos[3 * (size_t)b];
    const double cand[3][3] = {
        {pa[0], pa[1], pa[2]},
        {pb[0], pb[1], pb[2]},
        {0.5 * (pa[0] + pb[0]), 0.5 * (pa[1] + pb[1]), 0.5 * (pa[2] + pb[2])}};
    int best = 0;
    double bc = qerr(qs, cand[0][0], cand[0][1], cand[0][2]);
    for (int c = 1; c < 3; ++c) {
      const double cc = qerr(qs, cand[c][0], cand[c][1], cand[c][2]);
      if (cc < bc) {
        bc = cc;
        best = c;
      }
    }

    // collapse b -> a
    parent[b] = a;
    vpos[3 * (size_t)a] = cand[best][0];
    vpos[3 * (size_t)a + 1] = cand[best][1];
    vpos[3 * (size_t)a + 2] = cand[best][2];
    for (int j = 0; j < 10; ++j) Q[(size_t)a * 10 + j] = qs[j];
    ++ver[a];
    ++ver[b];

    // merge face incidence; kill faces that became degenerate
    auto& fa = vfaces[a];
    auto& fb = vfaces[b];
    for (const int32_t f : fb) {
      if (!alive[f]) continue;
      int32_t r[3];
      for (int v = 0; v < 3; ++v) r[v] = uf_find(parent.data(), faces[3 * f + v]);
      if (r[0] == r[1] || r[1] == r[2] || r[0] == r[2]) {
        alive[f] = 0;
        --live_faces;
      } else {
        fa.push_back(f);
      }
    }
    fb.clear();
    fb.shrink_to_fit();

    // refresh costs of a's surviving edges (old entries are version-stale)
    std::unordered_set<int32_t> nbrs;
    for (const int32_t f : fa) {
      if (!alive[f]) continue;
      for (int v = 0; v < 3; ++v) {
        const int32_t u = uf_find(parent.data(), faces[3 * f + v]);
        if (u != a) nbrs.insert(u);
      }
    }
    for (const int32_t u : nbrs) push_edge(a < u ? a : u, a < u ? u : a);
  }

  // compact: new ids for root vertices referenced by live faces
  std::vector<int32_t> newid((size_t)n_verts, -1);
  int32_t nv = 0;
  int32_t nf = 0;
  for (int64_t f = 0; f < n_faces; ++f) {
    if (!alive[f]) continue;
    int32_t r[3];
    for (int v = 0; v < 3; ++v) r[v] = uf_find(parent.data(), faces[3 * f + v]);
    if (r[0] == r[1] || r[1] == r[2] || r[0] == r[2]) continue;  // paranoia
    for (int v = 0; v < 3; ++v) {
      if (newid[r[v]] < 0) {
        newid[r[v]] = nv;
        out_verts[3 * nv] = (float)vpos[3 * (size_t)r[v]];
        out_verts[3 * nv + 1] = (float)vpos[3 * (size_t)r[v] + 1];
        out_verts[3 * nv + 2] = (float)vpos[3 * (size_t)r[v] + 2];
        ++nv;
      }
    }
    out_faces[3 * nf] = newid[r[0]];
    out_faces[3 * nf + 1] = newid[r[1]];
    out_faces[3 * nf + 2] = newid[r[2]];
    ++nf;
  }
  *n_out_verts = nv;
  return nf;
}

// Marching-tetrahedra geometry emission over a precomputed list of
// sign-change cells (the Python side finds candidate cells with a vectorized
// scan; the per-cell edge-dedup + interpolation here was the numpy hot spot:
// ~20 s for 1.1M verts at 385^3, ~1 s in C++). Topology tables are passed in
// from ops/surface.py so there is exactly one source of truth.
//
// Returns 0 on success, 1 when out_verts/out_faces capacity was exhausted
// (counts are still written; caller treats it as overflow).
int32_t marching_tets_cells(
    int32_t n, const float* s, int64_t n_cells, const int32_t* cells,
    const int32_t* tets,          // [6][4] cell-corner ids per tet
    const int32_t* tri_table,     // [6][16][2][3] edge ids or -1
    const int32_t* edge_corners,  // [6][n_edges][2] edge -> corner pair
    int32_t n_edges_per_tet,
    const int32_t* corners,       // [8][3] cell corner offsets
    const int32_t* dirs,          // [7][3] edge directions
    const int32_t* bit2dir,       // [8] (dx*4+dy*2+dz) -> dir id
    const double* bbox_min, const double* step,
    float* out_verts, int32_t* out_faces, int64_t* out_counts,
    int64_t max_v, int64_t max_f) {
  std::unordered_map<int64_t, int32_t> edge_slot;
  edge_slot.reserve((size_t)(n_cells * 4));
  int64_t nv = 0, nf = 0;
  const int64_t nn = (int64_t)n * n;

  for (int64_t c = 0; c < n_cells; ++c) {
    const int32_t ci = cells[3 * c], cj = cells[3 * c + 1],
                  ck = cells[3 * c + 2];
    int ins[8];
    for (int k = 0; k < 8; ++k) {
      const int64_t gi = ci + corners[3 * k], gj = cj + corners[3 * k + 1],
                    gk = ck + corners[3 * k + 2];
      ins[k] = s[gi * nn + gj * n + gk] < 0.f;
    }
    for (int t = 0; t < 6; ++t) {
      const int cse = ins[tets[4 * t]] + 2 * ins[tets[4 * t + 1]] +
                      4 * ins[tets[4 * t + 2]] + 8 * ins[tets[4 * t + 3]];
      for (int tri = 0; tri < 2; ++tri) {
        const int32_t* e = &tri_table[(((int64_t)t * 16 + cse) * 2 + tri) * 3];
        if (e[0] < 0) continue;
        if (nf >= max_f) goto overflow;
        for (int v = 0; v < 3; ++v) {
          const int32_t* ec =
              &edge_corners[((int64_t)t * n_edges_per_tet + e[v]) * 2];
          const int32_t* ca = &corners[3 * ec[0]];
          const int32_t* cb = &corners[3 * ec[1]];
          const int32_t lx = (ca[0] < cb[0] ? ca[0] : cb[0]) + ci;
          const int32_t ly = (ca[1] < cb[1] ? ca[1] : cb[1]) + cj;
          const int32_t lz = (ca[2] < cb[2] ? ca[2] : cb[2]) + ck;
          const int32_t dx = ca[0] ^ cb[0], dy = ca[1] ^ cb[1],
                        dz = ca[2] ^ cb[2];  // offsets are 0/1
          const int32_t dir = bit2dir[dx * 4 + dy * 2 + dz];
          const int64_t key = ((int64_t)lx * nn + (int64_t)ly * n + lz) * 7
                              + dir;
          auto it = edge_slot.find(key);
          int32_t slot;
          if (it == edge_slot.end()) {
            if (nv >= max_v) goto overflow;
            const int64_t i1 = (int64_t)lx * nn + (int64_t)ly * n + lz;
            const int32_t* d3 = &dirs[3 * dir];
            const int64_t i2 = (int64_t)(lx + d3[0]) * nn +
                               (int64_t)(ly + d3[1]) * n + (lz + d3[2]);
            const double s1 = s[i1], s2 = s[i2];
            const double den = s1 - s2;
            double tt = (den != 0.0) ? s1 / den : 0.5;
            if (tt < 0.0) tt = 0.0;
            if (tt > 1.0) tt = 1.0;
            out_verts[3 * nv] = (float)(bbox_min[0] + (lx + tt * d3[0]) * step[0]);
            out_verts[3 * nv + 1] =
                (float)(bbox_min[1] + (ly + tt * d3[1]) * step[1]);
            out_verts[3 * nv + 2] =
                (float)(bbox_min[2] + (lz + tt * d3[2]) * step[2]);
            slot = (int32_t)nv++;
            edge_slot.emplace(key, slot);
          } else {
            slot = it->second;
          }
          out_faces[3 * nf + v] = slot;
        }
        ++nf;
      }
    }
  }
  out_counts[0] = nv;
  out_counts[1] = nf;
  return 0;
overflow:
  out_counts[0] = nv;
  out_counts[1] = nf;
  return 1;
}

}  // extern "C"
