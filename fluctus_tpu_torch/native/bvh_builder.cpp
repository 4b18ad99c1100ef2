// Native BVH builders (the port's copy of the reference package's
// native/bvh_builder.cpp), each behind a plain C interface for ctypes:
//
//  * flbvh_*: full-sweep SAH (the same algorithm as accel/bvh.py,
//    src/bvh.cpp:237-440): sort refs by centroid per axis, prefix/suffix
//    AABB sweeps, costBox = costTri = 1, MaxLeafElems = 8;
//  * flsbvh_*: the spatial-split BVH (accel/sbvh.py, src/sbvh.cpp).
//
// Both write the flat layout, left child = node + 1. Build:
//   g++ -O3 -shared -fPIC -o libflbvh.so bvh_builder.cpp
// with no -march=native and no -ffast-math: contracting a*b+c into an FMA
// would change the doubles, and with them the tree.
//
// The renderer takes the SAH builder past 20,000 triangles (full-sweep SAH
// over a few hundred thousand triangles is minutes in numpy and about a
// second here) and the SBVH builder at every size. Their output must equal
// the reference's native builders bit for bit (the cluster tables are cut
// from it), so the box and area arithmetic, the costs and the
// (centroid, index) sort order are kept as they are.

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

// ---------------------------------------------------------------------------
// SBVH — spatial-split BVH with the same semantics as accel/sbvh.py (itself
// a re-derivation of src/sbvh.cpp's algorithm): full-sweep object SAH,
// 128-bin chopped spatial binning gated on child overlap, SAH unsplitting,
// reference duplication. Box math in double to track the numpy float64
// builder. Output layout identical to the SAH builder above.
// ---------------------------------------------------------------------------

constexpr int kNumSpatialBins = 128;
constexpr int kMaxSpatialDepth = 48;
constexpr double kSplitAlpha = 1e-5;

struct SRef {
  double bmin[3], bmax[3];
  uint32_t ind;
};

inline double darea(const double lo[3], const double hi[3]) {
  double d0 = hi[0] - lo[0], d1 = hi[1] - lo[1], d2 = hi[2] - lo[2];
  if (d0 < 0 || d1 < 0 || d2 < 0) return 0.0;
  return 2.0 * (d0 * d1 + d0 * d2 + d1 * d2);
}

inline void dexpand(double lo[3], double hi[3], const SRef& r) {
  for (int k = 0; k < 3; k++) {
    lo[k] = std::min(lo[k], r.bmin[k]);
    hi[k] = std::max(hi[k], r.bmax[k]);
  }
}

constexpr double kInf = std::numeric_limits<double>::infinity();

struct Box {
  double mn[3] = {kInf, kInf, kInf}, mx[3] = {-kInf, -kInf, -kInf};
  void add(const double* a, const double* b) {
    for (int k = 0; k < 3; k++) {
      mn[k] = std::min(mn[k], a[k]);
      mx[k] = std::max(mx[k], b[k]);
    }
  }
  void addp(const double p[3]) { add(p, p); }
  bool valid() const { return mn[0] <= mx[0]; }
  double area() const {
    for (int k = 0; k < 3; k++)
      if (!(mn[k] <= mx[k])) return 0.0;  // empty/inf -> 0 (py `area` lambda)
    return darea(mn, mx);
  }
};

// Clip one triangle reference against plane x[dim]=coord
// (sbvh.py:_split_reference / sbvh.cpp:414-453).
void split_reference(const double v[3][3], const double* rbmin,
                     const double* rbmax, int dim, double coord, Box& l,
                     Box& r) {
  for (int i = 0; i < 3; i++) {
    const double* p1 = v[i];
    const double* p2 = v[(i + 1) % 3];
    double v0p = p1[dim], v1p = p2[dim];
    if (v0p <= coord) l.addp(p1);
    if (v0p >= coord) r.addp(p1);
    if ((v0p < coord && coord < v1p) || (v1p < coord && coord < v0p)) {
      double t = std::max(0.0, std::min(1.0, (coord - v0p) / (v1p - v0p)));
      double x[3];
      for (int k = 0; k < 3; k++) x[k] = p1[k] * (1.0 - t) + p2[k] * t;
      l.addp(x);
      r.addp(x);
    }
  }
  l.mx[dim] = coord;
  r.mn[dim] = coord;
  for (int k = 0; k < 3; k++) {
    l.mn[k] = std::max(l.mn[k], rbmin[k]);
    l.mx[k] = std::min(l.mx[k], rbmax[k]);
    r.mn[k] = std::max(r.mn[k], rbmin[k]);
    r.mx[k] = std::min(r.mx[k], rbmax[k]);
  }
}

// AABB of triangle geometry within slab a <= x[dim] <= b, intersected with
// the reference box (sbvh.py:_clip_tri_slab).
Box clip_tri_slab(const double v[3][3], const double* rbmin,
                  const double* rbmax, int dim, double a, double b) {
  Box box;
  for (int i = 0; i < 3; i++)
    if (v[i][dim] >= a && v[i][dim] <= b) box.addp(v[i]);
  static const int edges[3][2] = {{0, 1}, {1, 2}, {2, 0}};
  for (auto& e : edges) {
    double xi = v[e[0]][dim], xj = v[e[1]][dim];
    double denom = xj - xi;
    if (denom == 0.0) continue;
    for (double plane : {a, b}) {
      double t = (plane - xi) / denom;
      if (t > 0.0 && t < 1.0) {
        double p[3];
        for (int k = 0; k < 3; k++)
          p[k] = v[e[0]][k] + t * (v[e[1]][k] - v[e[0]][k]);
        box.addp(p);
      }
    }
  }
  box.mn[dim] = std::max(box.mn[dim], a);
  box.mx[dim] = std::min(box.mx[dim], b);
  for (int k = 0; k < 3; k++) {
    box.mn[k] = std::max(box.mn[k], rbmin[k]);
    box.mx[k] = std::min(box.mx[k], rbmax[k]);
  }
  return box;
}

struct SBuilder {
  const float* tris = nullptr;  // [m][9]
  int max_leaf = kMaxLeaf;
  double min_overlap = 0.0;
  std::vector<Node> nodes;
  std::vector<uint32_t> indices;
  int64_t n_spatial = 0, n_dup = 0;

  void tri_verts(uint32_t ind, double v[3][3]) const {
    const float* p = tris + (size_t)ind * 9;
    for (int i = 0; i < 3; i++)
      for (int k = 0; k < 3; k++) v[i][k] = (double)p[i * 3 + k];
  }

  // Full-sweep object SAH (sbvh.py:_sah_object_split). Sorts refs by
  // (centroid[dim], ind); returns cost and fills order/split/child boxes.
  double object_split(std::vector<SRef>& refs, double node_sah,
                      int& best_dim, size_t& best_i, Box& lb, Box& rb) {
    size_t k = refs.size();
    double best_cost = kInf, best_tb = kInf;
    best_dim = -1;
    std::vector<double> smin(k * 3), smax(k * 3);
    for (int dim = 0; dim < 3; dim++) {
      std::sort(refs.begin(), refs.end(), [dim](const SRef& a,
                                                const SRef& b) {
        double ca = a.bmin[dim] + a.bmax[dim], cb = b.bmin[dim] + b.bmax[dim];
        return ca < cb || (ca == cb && a.ind < b.ind);
      });
      double rlo[3] = {kInf, kInf, kInf}, rhi[3] = {-kInf, -kInf, -kInf};
      for (int64_t i = (int64_t)k - 1; i >= 0; i--) {
        dexpand(rlo, rhi, refs[i]);
        std::memcpy(&smin[i * 3], rlo, 24);
        std::memcpy(&smax[i * 3], rhi, 24);
      }
      double llo[3] = {kInf, kInf, kInf}, lhi[3] = {-kInf, -kInf, -kInf};
      for (size_t i = 0; i + 1 < k; i++) {
        dexpand(llo, lhi, refs[i]);
        double la = darea(llo, lhi);
        double ra = darea(&smin[(i + 1) * 3], &smax[(i + 1) * 3]);
        double nl = (double)(i + 1), nr = (double)(k - i - 1);
        double cost = node_sah + (nl * la + nr * ra);
        double tb = nl * nl + nr * nr;
        if (cost < best_cost || (cost == best_cost && tb < best_tb)) {
          best_cost = cost;
          best_tb = tb;
          best_dim = dim;
          best_i = i;
          std::memcpy(lb.mn, llo, 24);
          std::memcpy(lb.mx, lhi, 24);
          std::memcpy(rb.mn, &smin[(i + 1) * 3], 24);
          std::memcpy(rb.mx, &smax[(i + 1) * 3], 24);
        }
      }
    }
    return best_cost;
  }

  // Chopped-binning spatial split search (sbvh.py:_bin_split).
  double bin_split(const std::vector<SRef>& refs, const double* nbmin,
                   const double* nbmax, double node_sah, int& out_dim,
                   double& out_pos) {
    size_t k = refs.size();
    double best = kInf;
    out_dim = -1;
    for (int dim = 0; dim < 3; dim++) {
      double ext = nbmax[dim] - nbmin[dim];
      double bs = ext / kNumSpatialBins;
      if (bs <= 0.0) continue;
      double inv = 1.0 / bs;
      Box bins[kNumSpatialBins];
      int64_t entering[kNumSpatialBins] = {0}, exiting[kNumSpatialBins] = {0};
      for (const SRef& r : refs) {
        int64_t f = (int64_t)((r.bmin[dim] - nbmin[dim]) * inv);
        f = std::max<int64_t>(0, std::min<int64_t>(f, kNumSpatialBins - 1));
        int64_t l = (int64_t)((r.bmax[dim] - nbmin[dim]) * inv);
        l = std::max<int64_t>(f, std::min<int64_t>(l, kNumSpatialBins - 1));
        entering[f]++;
        exiting[l]++;
        if (f == l) {
          bins[f].add(r.bmin, r.bmax);
        } else {
          double v[3][3];
          tri_verts(r.ind, v);
          for (int64_t bi = f; bi <= l; bi++) {
            double a = nbmin[dim] + bs * (double)bi;
            Box c = clip_tri_slab(v, r.bmin, r.bmax, dim, a, a + bs);
            if (c.valid()) bins[bi].add(c.mn, c.mx);
          }
        }
      }
      // sweep
      Box lacc;
      double lcount = 0;
      std::vector<double> ra(kNumSpatialBins), rn(kNumSpatialBins);
      {
        Box racc;
        for (int i = kNumSpatialBins - 1; i >= 0; i--) {
          if (bins[i].mn[0] != kInf) racc.add(bins[i].mn, bins[i].mx);
          ra[i] = racc.mn[0] == kInf ? kInf : darea(racc.mn, racc.mx);
        }
        double c = 0;  // rn[i] = k - sum(exiting[0..i-1])
        for (int i = 0; i < kNumSpatialBins; i++) {
          rn[i] = (double)k - c;
          c += (double)exiting[i];
        }
      }
      for (int i = 0; i + 1 < kNumSpatialBins; i++) {
        if (bins[i].mn[0] != kInf) lacc.add(bins[i].mn, bins[i].mx);
        lcount += (double)entering[i];
        double la = lacc.mn[0] == kInf ? kInf : darea(lacc.mn, lacc.mx);
        double rar = ra[i + 1];
        if (la == kInf || rar == kInf) continue;
        double sah = node_sah + la * lcount + rar * rn[i + 1];
        if (sah < best) {
          best = sah;
          out_dim = dim;
          out_pos = nbmin[dim] + bs * (double)(i + 1);
        }
      }
    }
    return best;
  }

  // Distribute refs about the plane with SAH unsplitting
  // (sbvh.py:_partition_spatial). Returns false if one side empties.
  bool partition_spatial(const std::vector<SRef>& refs, int dim, double pos,
                         std::vector<SRef>& left, std::vector<SRef>& right) {
    Box lbox, rbox;
    int64_t n_left = 0, n_right = 0;
    std::vector<size_t> straddle;
    for (size_t i = 0; i < refs.size(); i++) {
      const SRef& r = refs[i];
      if (r.bmax[dim] <= pos) {
        left.push_back(r);
        lbox.add(r.bmin, r.bmax);
        n_left++;
      } else if (r.bmin[dim] >= pos) {
        right.push_back(r);
        rbox.add(r.bmin, r.bmax);
        n_right++;
      } else {
        straddle.push_back(i);
      }
    }
    for (size_t si : straddle) {
      const SRef& r = refs[si];
      double v[3][3];
      tri_verts(r.ind, v);
      Box lc, rc;
      split_reference(v, r.bmin, r.bmax, dim, pos, lc, rc);

      // Stich et al. reference unsplitting: compare keeping the whole ref
      // on one side against duplicating the clipped halves into both.
      Box grown_left = lbox, grown_right = rbox;
      Box clipped_left = lbox, clipped_right = rbox;
      grown_left.add(r.bmin, r.bmax);
      grown_right.add(r.bmin, r.bmax);
      clipped_left.add(lc.mn, lc.mx);
      clipped_right.add(rc.mn, rc.mx);

      double cnt_l = (double)n_left, cnt_r = (double)n_right;
      double cnt_l1 = (double)(n_left + 1), cnt_r1 = (double)(n_right + 1);
      double unsplit_left = grown_left.area() * cnt_l1 + rbox.area() * cnt_r;
      double unsplit_right = lbox.area() * cnt_l + grown_right.area() * cnt_r1;
      double duplicate =
          clipped_left.area() * cnt_l1 + clipped_right.area() * cnt_r1;
      double m = std::min(unsplit_left, std::min(unsplit_right, duplicate));

      if (m == unsplit_left) {
        left.push_back(r);
        lbox = grown_left;
        n_left++;
      } else if (m == unsplit_right) {
        right.push_back(r);
        rbox = grown_right;
        n_right++;
      } else {
        SRef lr = r, rr = r;
        std::memcpy(lr.bmin, lc.mn, 24);
        std::memcpy(lr.bmax, lc.mx, 24);
        std::memcpy(rr.bmin, rc.mn, 24);
        std::memcpy(rr.bmax, rc.mx, 24);
        left.push_back(lr);
        right.push_back(rr);
        lbox = clipped_left;
        rbox = clipped_right;
        n_left++;
        n_right++;
      }
    }
    return !left.empty() && !right.empty();
  }

  uint32_t build(std::vector<SRef>& refs, int32_t parent, int depth) {
    uint32_t node_id = (uint32_t)nodes.size();
    nodes.emplace_back();
    double lo[3] = {kInf, kInf, kInf}, hi[3] = {-kInf, -kInf, -kInf};
    for (const SRef& r : refs) dexpand(lo, hi, r);
    for (int c = 0; c < 3; c++) {
      nodes[node_id].bmin[c] = (float)lo[c];
      nodes[node_id].bmax[c] = (float)hi[c];
    }
    nodes[node_id].parent = parent;
    size_t k = refs.size();

    auto make_leaf = [&]() {
      nodes[node_id].nprims = (uint8_t)k;
      nodes[node_id].right_or_start = (uint32_t)indices.size();
      for (const SRef& r : refs) indices.push_back(r.ind);
    };

    if (k <= 1 || (depth >= kMaxDepth && k <= 255)) {  // MIN_LEAF_ELEMS = 1
      make_leaf();
      return node_id;
    }
    if (depth >= kMaxDepth) {
      // Depth-capped node with more refs than the uint8 leaf-count field
      // can hold (possible because spatial splits duplicate references):
      // force an object-median split on the widest centroid axis instead
      // of emitting a leaf whose claimed count mismatches its index slice.
      // Each half strictly shrinks, so recursion reaches k <= 255 leaves.
      double cmin[3] = {kInf, kInf, kInf}, cmax[3] = {-kInf, -kInf, -kInf};
      for (const SRef& r : refs)
        for (int c = 0; c < 3; c++) {
          double cc = (double)r.bmin[c] + (double)r.bmax[c];
          cmin[c] = std::min(cmin[c], cc);
          cmax[c] = std::max(cmax[c], cc);
        }
      int d = 0;
      for (int c = 1; c < 3; c++)
        if (cmax[c] - cmin[c] > cmax[d] - cmin[d]) d = c;
      std::sort(refs.begin(), refs.end(), [d](const SRef& a, const SRef& b) {
        double ca = a.bmin[d] + a.bmax[d], cb = b.bmin[d] + b.bmax[d];
        return ca < cb || (ca == cb && a.ind < b.ind);
      });
      size_t mid = k / 2;
      std::vector<SRef> left(refs.begin(), refs.begin() + mid);
      std::vector<SRef> right(refs.begin() + mid, refs.end());
      std::vector<SRef>().swap(refs);
      build(left, (int32_t)node_id, depth + 1);
      std::vector<SRef>().swap(left);
      uint32_t r = (uint32_t)nodes.size();
      nodes[node_id].right_or_start = r;
      nodes[node_id].nprims = 0;
      build(right, (int32_t)node_id, depth + 1);
      return node_id;
    }

    double parent_area = darea(lo, hi);
    double node_sah = parent_area + parent_area;

    int obj_dim = -1;
    size_t obj_i = 0;
    Box lb, rb;
    double obj_cost = object_split(refs, node_sah, obj_dim, obj_i, lb, rb);

    double spatial_cost = kInf, sp_pos = 0.0;
    int sp_dim = -1;
    if (depth < kMaxSpatialDepth && obj_dim >= 0) {
      double ov_min[3], ov_max[3];
      bool overlaps = true;
      for (int c = 0; c < 3; c++) {
        ov_min[c] = std::max(lb.mn[c], rb.mn[c]);
        ov_max[c] = std::min(lb.mx[c], rb.mx[c]);
        overlaps &= ov_max[c] >= ov_min[c];
      }
      if (overlaps && darea(ov_min, ov_max) >= min_overlap)
        spatial_cost = bin_split(refs, lo, hi, node_sah, sp_dim, sp_pos);
    }

    double leaf_cost = parent_area * (double)k;
    double min_cost = std::min(obj_cost, std::min(spatial_cost, leaf_cost));
    if (min_cost == leaf_cost && k <= (size_t)max_leaf) {
      make_leaf();
      return node_id;
    }

    std::vector<SRef> left, right;
    bool have_parts = false;
    if (min_cost == spatial_cost && sp_dim >= 0) {
      have_parts = partition_spatial(refs, sp_dim, sp_pos, left, right);
      if (!have_parts) {
        left.clear();
        right.clear();
      } else {
        n_spatial++;
      }
    }
    if (!have_parts) {
      // refs are sorted by dim 2 after object_split; re-sort by obj_dim
      if (obj_dim != 2) {
        std::sort(refs.begin(), refs.end(), [d = obj_dim](const SRef& a,
                                                          const SRef& b) {
          double ca = a.bmin[d] + a.bmax[d], cb = b.bmin[d] + b.bmax[d];
          return ca < cb || (ca == cb && a.ind < b.ind);
        });
      }
      left.assign(refs.begin(), refs.begin() + obj_i + 1);
      right.assign(refs.begin() + obj_i + 1, refs.end());
    }
    n_dup += (int64_t)(left.size() + right.size() - k);
    {
      std::vector<SRef>().swap(refs);  // free before recursing
    }
    build(left, (int32_t)node_id, depth + 1);
    {
      std::vector<SRef>().swap(left);
    }
    uint32_t r = (uint32_t)nodes.size();
    nodes[node_id].right_or_start = r;
    nodes[node_id].nprims = 0;
    build(right, (int32_t)node_id, depth + 1);
    return node_id;
  }
};

SBuilder* g_sbuilder = nullptr;


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

// tris: [m][9] floats. Returns number of nodes. Stats readable via
// flsbvh_stats; node/index arrays via flsbvh_read.
int64_t flsbvh_build(const float* tris, int64_t m, int32_t max_leaf) {
  delete g_sbuilder;
  g_sbuilder = new SBuilder();
  g_sbuilder->tris = tris;
  g_sbuilder->max_leaf = max_leaf;
  std::vector<SRef> refs((size_t)m);
  double rlo[3] = {kInf, kInf, kInf}, rhi[3] = {-kInf, -kInf, -kInf};
  for (int64_t i = 0; i < m; i++) {
    const float* v = tris + i * 9;
    SRef& r = refs[i];
    for (int k = 0; k < 3; k++) {
      r.bmin[k] = (double)std::min(v[k], std::min(v[3 + k], v[6 + k]));
      r.bmax[k] = (double)std::max(v[k], std::max(v[3 + k], v[6 + k]));
      rlo[k] = std::min(rlo[k], r.bmin[k]);
      rhi[k] = std::max(rhi[k], r.bmax[k]);
    }
    r.ind = (uint32_t)i;
  }
  g_sbuilder->min_overlap = darea(rlo, rhi) * kSplitAlpha;
  g_sbuilder->nodes.reserve((size_t)(3 * m));
  g_sbuilder->indices.reserve((size_t)(2 * m));
  g_sbuilder->build(refs, -1, 0);
  return (int64_t)g_sbuilder->nodes.size();
}

int64_t flsbvh_num_indices() {
  return g_sbuilder ? (int64_t)g_sbuilder->indices.size() : 0;
}

void flsbvh_stats(int64_t* n_spatial, int64_t* n_dup) {
  *n_spatial = g_sbuilder ? g_sbuilder->n_spatial : 0;
  *n_dup = g_sbuilder ? g_sbuilder->n_dup : 0;
}

void flsbvh_read(float* box_min, float* box_max, uint32_t* right_or_start,
                 int32_t* parent, uint8_t* nprims, uint32_t* indices) {
  if (!g_sbuilder) return;
  const auto& ns = g_sbuilder->nodes;
  for (size_t i = 0; i < ns.size(); i++) {
    std::memcpy(box_min + i * 3, ns[i].bmin, 12);
    std::memcpy(box_max + i * 3, ns[i].bmax, 12);
    right_or_start[i] = ns[i].right_or_start;
    parent[i] = ns[i].parent;
    nprims[i] = ns[i].nprims;
  }
  std::memcpy(indices, g_sbuilder->indices.data(),
              g_sbuilder->indices.size() * 4);
  delete g_sbuilder;
  g_sbuilder = nullptr;
}

}  // extern "C"
