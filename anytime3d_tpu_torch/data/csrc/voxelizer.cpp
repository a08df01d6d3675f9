// Native mesh voxelizer: triangle mesh -> solid occupancy grid. The port's
// copy of the JAX package's native/voxelizer.cpp, the algorithm unchanged so
// that the grids are bit-equal; built by
// anytime3d_tpu_torch/kernels/build.py::build_host and called through ctypes
// by data/voxelize.py.
//
// Surface rasterization via conservative triangle-box overlap, then solid
// fill by X-ray parity counting along +z columns (crossing number), matching
// the usual binvox-style convention. Both passes run on a thread pool.
// Greedy host NMS (nms_host) rides along.
//
// Build: g++ -O3 -march=native -std=c++17 -fPIC -shared -o libvoxelizer.so voxelizer.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 sub(const Vec3& a, const Vec3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float dot(const Vec3& a, const Vec3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// Separating-axis triangle / axis-aligned-box overlap (Akenine-Moller).
bool tri_box_overlap(const Vec3& c, const Vec3& h, const Vec3 v[3]) {
  Vec3 t[3] = {sub(v[0], c), sub(v[1], c), sub(v[2], c)};
  Vec3 e[3] = {sub(t[1], t[0]), sub(t[2], t[1]), sub(t[0], t[2])};

  // 9 cross-product axes
  for (int i = 0; i < 3; ++i) {
    const Vec3& ed = e[i];
    const Vec3 axes[3] = {{0, -ed.z, ed.y}, {ed.z, 0, -ed.x}, {-ed.y, ed.x, 0}};
    for (int j = 0; j < 3; ++j) {
      const Vec3& a = axes[j];
      float p0 = dot(a, t[0]), p1 = dot(a, t[1]), p2 = dot(a, t[2]);
      float r = h.x * std::fabs(a.x) + h.y * std::fabs(a.y) + h.z * std::fabs(a.z);
      float mn = std::min({p0, p1, p2}), mx = std::max({p0, p1, p2});
      if (mn > r || mx < -r) return false;
    }
  }
  // box face axes
  for (int i = 0; i < 3; ++i) {
    float mn, mx, r;
    if (i == 0) { mn = std::min({t[0].x, t[1].x, t[2].x}); mx = std::max({t[0].x, t[1].x, t[2].x}); r = h.x; }
    else if (i == 1) { mn = std::min({t[0].y, t[1].y, t[2].y}); mx = std::max({t[0].y, t[1].y, t[2].y}); r = h.y; }
    else { mn = std::min({t[0].z, t[1].z, t[2].z}); mx = std::max({t[0].z, t[1].z, t[2].z}); r = h.z; }
    if (mn > r || mx < -r) return false;
  }
  // triangle plane
  Vec3 n = cross(e[0], e[1]);
  float d = -dot(n, t[0]);
  float r = h.x * std::fabs(n.x) + h.y * std::fabs(n.y) + h.z * std::fabs(n.z);
  return std::fabs(d) <= r;
}

// Watertight ray crossing: does segment of +z column (x, y) cross triangle?
// Returns z of intersection in *z_hit (top-left rule not needed for parity
// with epsilon jitter applied by caller).
bool ray_z_triangle(float x, float y, const Vec3 v[3], float* z_hit) {
  // 2D edge functions in xy
  float d1 = (v[1].x - v[0].x) * (y - v[0].y) - (v[1].y - v[0].y) * (x - v[0].x);
  float d2 = (v[2].x - v[1].x) * (y - v[1].y) - (v[2].y - v[1].y) * (x - v[1].x);
  float d3 = (v[0].x - v[2].x) * (y - v[2].y) - (v[0].y - v[2].y) * (x - v[2].x);
  bool has_neg = (d1 < 0) || (d2 < 0) || (d3 < 0);
  bool has_pos = (d1 > 0) || (d2 > 0) || (d3 > 0);
  if (has_neg && has_pos) return false;
  // barycentric z
  float area = d1 + d2 + d3;
  if (std::fabs(area) < 1e-12f) return false;
  float w0 = d2 / area, w1 = d3 / area, w2 = d1 / area;
  *z_hit = w0 * v[0].z + w1 * v[1].z + w2 * v[2].z;
  return true;
}

}  // namespace

extern "C" {

// verts: (n_verts, 3) float32; tris: (n_tris, 3) int32; out: (dim³) uint8.
// Mesh is normalized by the caller into [0, dim] coordinates.
// mode: 0 = surface only, 1 = solid (surface + parity fill).
void voxelize_mesh(const float* verts, int64_t n_verts, const int32_t* tris,
                   int64_t n_tris, int32_t dim, int32_t mode, uint8_t* out,
                   int32_t n_threads) {
  std::memset(out, 0, (size_t)dim * dim * dim);
  if (n_threads <= 0) n_threads = (int32_t)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;

  // ---- pass 1: conservative surface rasterization, parallel over triangles
  {
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
      int64_t ti;
      while ((ti = next.fetch_add(1)) < n_tris) {
        Vec3 v[3];
        for (int k = 0; k < 3; ++k) {
          const float* p = verts + (int64_t)tris[ti * 3 + k] * 3;
          v[k] = {p[0], p[1], p[2]};
        }
        int x0 = std::max(0, (int)std::floor(std::min({v[0].x, v[1].x, v[2].x})));
        int x1 = std::min(dim - 1, (int)std::floor(std::max({v[0].x, v[1].x, v[2].x})));
        int y0 = std::max(0, (int)std::floor(std::min({v[0].y, v[1].y, v[2].y})));
        int y1 = std::min(dim - 1, (int)std::floor(std::max({v[0].y, v[1].y, v[2].y})));
        int z0 = std::max(0, (int)std::floor(std::min({v[0].z, v[1].z, v[2].z})));
        int z1 = std::min(dim - 1, (int)std::floor(std::max({v[0].z, v[1].z, v[2].z})));
        Vec3 h = {0.5f, 0.5f, 0.5f};
        for (int x = x0; x <= x1; ++x)
          for (int y = y0; y <= y1; ++y)
            for (int z = z0; z <= z1; ++z) {
              Vec3 c = {x + 0.5f, y + 0.5f, z + 0.5f};
              if (tri_box_overlap(c, h, v))
                // triangles overlap in space, so two threads can mark the
                // same voxel; a relaxed atomic store keeps the same-value
                // write defined (plain stores here are a TSan-reported race)
                __atomic_store_n(&out[((int64_t)x * dim + y) * dim + z],
                                 (uint8_t)1, __ATOMIC_RELAXED);
            }
      }
    };
    std::vector<std::thread> pool;
    for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }

  if (mode == 0) return;

  // ---- pass 2: solid fill by +z parity counting, parallel over columns
  {
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
      int64_t col;
      std::vector<float> hits;
      while ((col = next.fetch_add(1)) < (int64_t)dim * dim) {
        int x = (int)(col / dim), y = (int)(col % dim);
        // irrational jitter: keeps the ray off shared triangle edges, which
        // would otherwise double- or zero-count crossings and break parity
        float cx = x + 0.5f + 1.2345e-4f, cy = y + 0.5f + 3.1713e-4f;
        hits.clear();
        for (int64_t ti = 0; ti < n_tris; ++ti) {
          Vec3 v[3];
          for (int k = 0; k < 3; ++k) {
            const float* p = verts + (int64_t)tris[ti * 3 + k] * 3;
            v[k] = {p[0], p[1], p[2]};
          }
          float zh;
          if (ray_z_triangle(cx, cy, v, &zh)) hits.push_back(zh);
        }
        if (hits.size() < 2) continue;
        std::sort(hits.begin(), hits.end());
        // dedupe coincident hits (ray through a shared vertex/edge)
        size_t w = 1;
        for (size_t i = 1; i < hits.size(); ++i)
          if (hits[i] - hits[w - 1] > 1e-5f) hits[w++] = hits[i];
        hits.resize(w);
        // fill between alternating pairs
        for (size_t i = 0; i + 1 < hits.size(); i += 2) {
          int za = std::max(0, (int)std::ceil(hits[i] - 0.5f));
          int zb = std::min(dim - 1, (int)std::floor(hits[i + 1] - 0.5f));
          for (int z = za; z <= zb; ++z)
            out[((int64_t)x * dim + y) * dim + z] = 1;
        }
      }
    };
    std::vector<std::thread> pool;
    for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
}

// Batched greedy NMS on host (detection post-processing without device
// round-trip). boxes: (n, 5) [x0, y0, x1, y1, score]; keep: (n) uint8 out.
void nms_host(const float* boxes, int64_t n, float iou_thresh, uint8_t* keep) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return boxes[a * 5 + 4] > boxes[b * 5 + 4];
  });
  std::vector<uint8_t> suppressed(n, 0);
  std::memset(keep, 0, n);
  for (int64_t oi = 0; oi < n; ++oi) {
    int64_t i = order[oi];
    if (suppressed[i]) continue;
    keep[i] = 1;
    const float* bi = boxes + i * 5;
    float ai = (bi[2] - bi[0]) * (bi[3] - bi[1]);
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      int64_t j = order[oj];
      if (suppressed[j]) continue;
      const float* bj = boxes + j * 5;
      float aj = (bj[2] - bj[0]) * (bj[3] - bj[1]);
      float xx0 = std::max(bi[0], bj[0]), yy0 = std::max(bi[1], bj[1]);
      float xx1 = std::min(bi[2], bj[2]), yy1 = std::min(bi[3], bj[3]);
      float w = std::max(0.0f, xx1 - xx0), h = std::max(0.0f, yy1 - yy0);
      float inter = w * h;
      float iou = inter / (ai + aj - inter + 1e-12f);
      if (iou > iou_thresh) suppressed[j] = 1;
    }
  }
}

}  // extern "C"
