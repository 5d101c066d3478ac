// Native host-side preprocessing ops for rnnpose_tpu.
//
// TPU-native equivalents of the reference's C++ extensions
// (grid subsampling: `thirdparty/kpconv/cpp_wrappers/cpp_subsampling/
// grid_subsampling.cpp:5-110`; fixed-radius neighbors with nanoflann:
// `cpp_neighbors/neighbors.cpp:125-206,209+`), re-implemented from scratch:
//   * grid_subsample: voxel-grid barycenters via open-addressing hash map,
//     first-occupancy ordering (matches the numpy reference in
//     data/pyramid.py bit-for-bit in ordering semantics).
//   * radius_neighbors: median-split kd-tree, distance-ordered results,
//     dense output with shadow index = n_support.
//
// Exposed via extern "C" for ctypes (no pybind11 in the image).
// Build: rnnpose_tpu/cpp/build.py (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

// ---------------------------------------------------------------------------
// Grid subsampling
// ---------------------------------------------------------------------------

struct Cell {
  int64_t key = -1;
  double sx = 0, sy = 0, sz = 0;
  int64_t count = 0;
  int64_t order = -1;  // first-occupancy rank
};

class VoxelMap {
 public:
  explicit VoxelMap(size_t expected) {
    size_t cap = 16;
    while (cap < expected * 2) cap <<= 1;
    cells_.resize(cap);
  }

  Cell* upsert(int64_t key) {
    size_t mask = cells_.size() - 1;
    size_t h = static_cast<size_t>(key * 0x9E3779B97F4A7C15ULL) & mask;
    while (true) {
      Cell& c = cells_[h];
      if (c.key == key) return &c;
      if (c.key == -1) {
        if (++used_ * 2 > cells_.size()) {
          grow();
          return upsert(key);
        }
        c.key = key;
        c.order = next_order_++;
        return &c;
      }
      h = (h + 1) & mask;
    }
  }

  std::vector<Cell> cells_;
  size_t used_ = 0;
  int64_t next_order_ = 0;

 private:
  void grow() {
    std::vector<Cell> old;
    old.swap(cells_);
    cells_.resize(old.size() * 2);
    used_ = 0;
    size_t mask = cells_.size() - 1;
    for (const Cell& c : old) {
      if (c.key == -1) continue;
      size_t h = static_cast<size_t>(c.key * 0x9E3779B97F4A7C15ULL) & mask;
      while (cells_[h].key != -1) h = (h + 1) & mask;
      cells_[h] = c;
      ++used_;
    }
  }
};

// ---------------------------------------------------------------------------
// KD-tree (3D, median split)
// ---------------------------------------------------------------------------

struct KDNode {
  float split;
  int axis;         // -1 for leaf
  int left, right;  // child node ids, or [begin, end) into indices for leaf
};

class KDTree {
 public:
  KDTree(const float* pts, int n) : pts_(pts), n_(n) {
    idx_.resize(n);
    std::iota(idx_.begin(), idx_.end(), 0);
    nodes_.reserve(n > 0 ? 2 * n / kLeaf + 4 : 4);
    if (n > 0) root_ = build(0, n);
  }

  // Collect (dist2, idx) of all points within radius of q.
  void radius_query(const float* q, float r2,
                    std::vector<std::pair<float, int>>* out) const {
    if (n_ > 0) query(root_, q, r2, out);
  }

 private:
  static constexpr int kLeaf = 16;

  int build(int begin, int end) {
    int node_id = static_cast<int>(nodes_.size());
    nodes_.emplace_back();
    if (end - begin <= kLeaf) {
      nodes_[node_id] = {0.f, -1, begin, end};
      return node_id;
    }
    // Pick widest axis.
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = begin; i < end; ++i) {
      const float* p = pts_ + 3 * idx_[i];
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], p[a]);
        hi[a] = std::max(hi[a], p[a]);
      }
    }
    int axis = 0;
    for (int a = 1; a < 3; ++a)
      if (hi[a] - lo[a] > hi[axis] - lo[axis]) axis = a;
    int mid = (begin + end) / 2;
    std::nth_element(
        idx_.begin() + begin, idx_.begin() + mid, idx_.begin() + end,
        [&](int a, int b) { return pts_[3 * a + axis] < pts_[3 * b + axis]; });
    float split = pts_[3 * idx_[mid] + axis];
    int left = build(begin, mid);
    int right = build(mid, end);
    nodes_[node_id] = {split, axis, left, right};
    return node_id;
  }

  void query(int node_id, const float* q, float r2,
             std::vector<std::pair<float, int>>* out) const {
    const KDNode& nd = nodes_[node_id];
    if (nd.axis == -1) {
      for (int i = nd.left; i < nd.right; ++i) {
        const float* p = pts_ + 3 * idx_[i];
        float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
        float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 <= r2) out->emplace_back(d2, idx_[i]);
      }
      return;
    }
    float d = q[nd.axis] - nd.split;
    int near = d < 0 ? nd.left : nd.right;
    int far = d < 0 ? nd.right : nd.left;
    query(near, q, r2, out);
    if (d * d <= r2) query(far, q, r2, out);
  }

  const float* pts_;
  int n_;
  std::vector<int> idx_;
  std::vector<KDNode> nodes_;
  int root_ = 0;
};

}  // namespace

extern "C" {

// Voxel-grid barycenter subsampling.
// points: (n, 3) float32; out: (n, 3) buffer; returns number of barycenters
// written (first-occupancy voxel order).
int grid_subsample(const float* points, int64_t n, float dl, float* out) {
  if (n == 0) return 0;
  float ox = points[0], oy = points[1], oz = points[2];
  for (int64_t i = 1; i < n; ++i) {
    ox = std::min(ox, points[3 * i]);
    oy = std::min(oy, points[3 * i + 1]);
    oz = std::min(oz, points[3 * i + 2]);
  }
  VoxelMap map(static_cast<size_t>(n));
  const float inv = 1.0f / dl;
  for (int64_t i = 0; i < n; ++i) {
    int64_t vx = static_cast<int64_t>(std::floor((points[3 * i] - ox) * inv));
    int64_t vy = static_cast<int64_t>(std::floor((points[3 * i + 1] - oy) * inv));
    int64_t vz = static_cast<int64_t>(std::floor((points[3 * i + 2] - oz) * inv));
    int64_t key = (vx << 42) + (vy << 21) + vz;
    Cell* c = map.upsert(key);
    c->sx += points[3 * i];
    c->sy += points[3 * i + 1];
    c->sz += points[3 * i + 2];
    c->count += 1;
  }
  // Order cells by first occupancy.
  std::vector<const Cell*> occupied;
  occupied.reserve(map.used_);
  for (const Cell& c : map.cells_)
    if (c.key != -1) occupied.push_back(&c);
  std::sort(occupied.begin(), occupied.end(),
            [](const Cell* a, const Cell* b) { return a->order < b->order; });
  int m = 0;
  for (const Cell* c : occupied) {
    out[3 * m] = static_cast<float>(c->sx / c->count);
    out[3 * m + 1] = static_cast<float>(c->sy / c->count);
    out[3 * m + 2] = static_cast<float>(c->sz / c->count);
    ++m;
  }
  return m;
}

// Fixed-radius neighbors, distance-ordered, shadow index = n_support.
// queries: (nq, 3), supports: (ns, 3); out: (nq, max_neighbors) int32.
void radius_neighbors(const float* queries, int64_t nq, const float* supports,
                      int64_t ns, float radius, int32_t max_neighbors,
                      int32_t* out) {
  KDTree tree(supports, static_cast<int>(ns));
  const float r2 = radius * radius;
  std::vector<std::pair<float, int>> found;
  for (int64_t i = 0; i < nq; ++i) {
    found.clear();
    tree.radius_query(queries + 3 * i, r2, &found);
    int k = std::min<int>(static_cast<int>(found.size()), max_neighbors);
    std::partial_sort(found.begin(), found.begin() + k, found.end());
    int32_t* row = out + i * max_neighbors;
    for (int j = 0; j < k; ++j) row[j] = found[j].second;
    for (int j = k; j < max_neighbors; ++j) row[j] = static_cast<int32_t>(ns);
  }
}

}  // extern "C"
