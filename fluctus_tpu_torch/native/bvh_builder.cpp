// Native full-sweep SAH BVH builder (the port's copy of the SAH part of the
// reference package's native/bvh_builder.cpp; the same algorithm as
// accel/bvh.py, src/bvh.cpp:237-440): sort refs by centroid per axis,
// prefix/suffix AABB sweeps, costBox = costTri = 1, MaxLeafElems = 8,
// left child = node + 1.
//
// A plain C interface for ctypes. Build:
//   g++ -O3 -shared -fPIC -o libflbvh.so bvh_builder.cpp
//
// The renderer takes it past 20,000 triangles: full-sweep SAH over a few
// hundred thousand triangles is minutes in numpy and about a second here.
// Its output must equal the reference's native builder bit for bit (the
// cluster tables are cut from it), so the float box and area arithmetic,
// the double cost and the (centroid, index) sort order are kept as they are.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Ref {
  float bmin[3];
  float bmax[3];
  float c2[3];  // 2x centroid, the sort key
  uint32_t ind;
};

struct Node {
  float bmin[3];
  float bmax[3];
  uint32_t right_or_start;
  int32_t parent;
  uint8_t nprims;
};

constexpr int kMaxLeaf = 8;
constexpr int kMaxDepth = 64;

inline float area(const float lo[3], const float hi[3]) {
  float d0 = hi[0] - lo[0], d1 = hi[1] - lo[1], d2 = hi[2] - lo[2];
  if (d0 < 0 || d1 < 0 || d2 < 0) return 0.f;
  return 2.f * (d0 * d1 + d0 * d2 + d1 * d2);
}

inline void expand(float lo[3], float hi[3], const Ref& r) {
  for (int k = 0; k < 3; k++) {
    lo[k] = std::min(lo[k], r.bmin[k]);
    hi[k] = std::max(hi[k], r.bmax[k]);
  }
}

struct Builder {
  std::vector<Ref> refs;
  std::vector<Node> nodes;
  std::vector<uint32_t> indices;
  std::vector<float> smin, smax;  // suffix sweep scratch

  void sort_axis(uint32_t s, uint32_t e, int d) {
    std::sort(refs.begin() + s, refs.begin() + e,
              [d](const Ref& a, const Ref& b) {
                return a.c2[d] < b.c2[d] ||
                       (a.c2[d] == b.c2[d] && a.ind < b.ind);
              });
  }

  uint32_t build(uint32_t s, uint32_t e, int32_t parent, int depth) {
    uint32_t node_id = (uint32_t)nodes.size();
    nodes.emplace_back();
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (uint32_t i = s; i < e; i++) expand(lo, hi, refs[i]);
    std::memcpy(nodes[node_id].bmin, lo, 12);
    std::memcpy(nodes[node_id].bmax, hi, 12);
    nodes[node_id].parent = parent;

    uint32_t count = e - s;
    if (count <= kMaxLeaf || depth >= kMaxDepth) {
      nodes[node_id].nprims = (uint8_t)std::min<uint32_t>(count, 255);
      nodes[node_id].right_or_start = (uint32_t)indices.size();
      for (uint32_t i = s; i < e; i++) indices.push_back(refs[i].ind);
      return node_id;
    }

    // full-sweep SAH over the 3 axes
    double best_cost = std::numeric_limits<double>::infinity();
    int best_dim = 0;
    uint32_t best_i = 0;
    double inv_parent = 1.0 / std::max((double)area(lo, hi), 1e-30);

    for (int dim = 0; dim < 3; dim++) {
      sort_axis(s, e, dim);
      smin.resize(count * 3);
      smax.resize(count * 3);
      float rlo[3] = {1e30f, 1e30f, 1e30f},
            rhi[3] = {-1e30f, -1e30f, -1e30f};
      for (int64_t i = count - 1; i >= 0; i--) {
        expand(rlo, rhi, refs[s + i]);
        std::memcpy(&smin[i * 3], rlo, 12);
        std::memcpy(&smax[i * 3], rhi, 12);
      }
      float llo[3] = {1e30f, 1e30f, 1e30f},
            lhi[3] = {-1e30f, -1e30f, -1e30f};
      for (uint32_t i = 0; i + 1 < count; i++) {
        expand(llo, lhi, refs[s + i]);
        double la = area(llo, lhi);
        double ra = area(&smin[(i + 1) * 3], &smax[(i + 1) * 3]);
        double cost =
            2.0 + ((i + 1) * la + (count - i - 1) * ra) * inv_parent;
        if (cost < best_cost) {
          best_cost = cost;
          best_dim = dim;
          best_i = i;
        }
      }
    }
    // the refs are sorted by axis 2 now; re-sort if the best axis differs
    if (best_dim != 2) sort_axis(s, e, best_dim);
    if (best_i == 0) best_i = 1;  // "fix indexing" (bvh.cpp:427-431)

    uint32_t mid = s + best_i + 1;
    build(s, mid, (int32_t)node_id, depth + 1);
    uint32_t right = build(mid, e, (int32_t)node_id, depth + 1);
    nodes[node_id].right_or_start = right;
    nodes[node_id].nprims = 0;
    return node_id;
  }
};

Builder* g_builder = nullptr;

}  // namespace

extern "C" {

// tris: [m][9] floats (3 vertices x xyz). Returns the number of nodes.
int64_t flbvh_build(const float* tris, int64_t m) {
  delete g_builder;
  g_builder = new Builder();
  g_builder->refs.resize(m);
  for (int64_t i = 0; i < m; i++) {
    const float* v = tris + i * 9;
    Ref& r = g_builder->refs[i];
    for (int k = 0; k < 3; k++) {
      r.bmin[k] = std::min(v[k], std::min(v[3 + k], v[6 + k]));
      r.bmax[k] = std::max(v[k], std::max(v[3 + k], v[6 + k]));
      r.c2[k] = r.bmin[k] + r.bmax[k];
    }
    r.ind = (uint32_t)i;
  }
  g_builder->nodes.reserve(2 * m);
  g_builder->indices.reserve(m);
  g_builder->build(0, (uint32_t)m, -1, 0);
  return (int64_t)g_builder->nodes.size();
}

int64_t flbvh_num_indices() {
  return g_builder ? (int64_t)g_builder->indices.size() : 0;
}

// Out buffers sized by the caller from flbvh_build / flbvh_num_indices;
// frees the builder.
void flbvh_read(float* box_min, float* box_max, uint32_t* right_or_start,
                int32_t* parent, uint8_t* nprims, uint32_t* indices) {
  if (!g_builder) return;
  const auto& ns = g_builder->nodes;
  for (size_t i = 0; i < ns.size(); i++) {
    std::memcpy(box_min + i * 3, ns[i].bmin, 12);
    std::memcpy(box_max + i * 3, ns[i].bmax, 12);
    right_or_start[i] = ns[i].right_or_start;
    parent[i] = ns[i].parent;
    nprims[i] = ns[i].nprims;
  }
  std::memcpy(indices, g_builder->indices.data(),
              g_builder->indices.size() * 4);
  delete g_builder;
  g_builder = nullptr;
}

}  // extern "C"
