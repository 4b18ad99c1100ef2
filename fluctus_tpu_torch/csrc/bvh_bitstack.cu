// bvh_bitstack — the bitstack BVH traversal of a scene without cluster
// tables: closest hit (t, triangle, u, v) or any-hit (occluded) per ray.
//
// Replaces: fluctus_tpu/accel/traverse.py, _traverse (called by closest_hit
// and any_hit). Not a Pallas kernel: in XLA it is one program, a
// lax.while_loop over the lockstep state machine of every ray; its plain
// PyTorch twin (accel/traverse.py, traverse_plain) launches some 150
// kernels and a host sync per step of that machine. Here it is one kernel.
//
// Bound on the H100: operations, from the rays' own work (each ray reads
// 28 B and writes 16 B; the tree and the triangles are read once): about
// 25 FP32 operations per box test (2 per inner node entered) and 53 per
// triangle test. The work is data-dependent: chip_smoke.py counts the
// tests of its rays with the plain version.
//
// Design: one thread per ray, looping in the kernel over its own node
// index and two 64-bit bitstacks (one bit per level: the left, the right
// child still to visit), the reference's machine taken one ray at a time:
// each turn of the loop is one step of the lockstep version for this ray
// (descend into an inner node, test a leaf, or backtrack one level), so
// the ray's path, and with it every t, u and v, is the plain version's.
// A simple kernel: the node and triangle arrays are read through the
// read-only path as separate SoA columns; no node layout, short stack or
// persistent threads yet.
//
// Bit-exactness with the plain version:
//  * min/max propagate NaN (jmin/jmax): an axis-parallel ray has 1/d = inf,
//    and an origin on a box plane makes (bmin - o) * inf NaN; the
//    reference rejects that box, fminf/fmaxf would keep it;
//  * inv_dir = 1 / d with IEEE division (d = -0.0 gives -inf);
//  * cross and dot in vec.py's order of terms, built with -fmad=false;
//  * the leaf keeps the first of equal t (strict <), in the order of
//    indices; lanes with t_max = 0 walk boxes that hold their origin and
//    hit nothing, as in the plain version.
#include "common.cuh"

struct Vec {
  float x, y, z;
};

__device__ __forceinline__ Vec ld3(const float* __restrict__ x,
                                   const float* __restrict__ y,
                                   const float* __restrict__ z, int i) {
  return Vec{__ldg(x + i), __ldg(y + i), __ldg(z + i)};
}
__device__ __forceinline__ Vec sub(Vec a, Vec b) {
  return Vec{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ Vec cross3(Vec a, Vec b) {
  return Vec{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
             a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float dot3(Vec a, Vec b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

struct Scene {
  const float *bminx, *bminy, *bminz, *bmaxx, *bmaxy, *bmaxz;
  const float *v0x, *v0y, *v0z, *e1x, *e1y, *e1z, *e2x, *e2y, *e2z;
  const int *ros, *parent, *nprims, *indices;
  int n_nodes, n_idx, max_leaf;
};

// Slab test (intersect.cl:41-60): hit, and tmin in *tn.
__device__ __forceinline__ bool box_hit(const Scene& s, int node, Vec o,
                                        Vec inv, float t_prev, float* tn) {
  const Vec bmin = ld3(s.bminx, s.bminy, s.bminz, node);
  const Vec bmax = ld3(s.bmaxx, s.bmaxy, s.bmaxz, node);
  const Vec t1{(bmin.x - o.x) * inv.x, (bmin.y - o.y) * inv.y,
               (bmin.z - o.z) * inv.z};
  const Vec t2{(bmax.x - o.x) * inv.x, (bmax.y - o.y) * inv.y,
               (bmax.z - o.z) * inv.z};
  const float tmin = jmax(jmax(jmin(t1.x, t2.x), jmin(t1.y, t2.y)),
                          jmin(t1.z, t2.z));
  const float tmax = jmin(jmin(jmax(t1.x, t2.x), jmax(t1.y, t2.y)),
                          jmax(t1.z, t2.z));
  *tn = tmin;
  return (tmax >= 0.0f) & (tmin <= tmax) & (tmin < t_prev);
}

// Moller-Trumbore (intersect.cl:62-93), the plain version's order.
__device__ __forceinline__ bool tri_hit(const Scene& s, int k, Vec o, Vec d,
                                        float* t, float* u, float* v) {
  const Vec v0 = ld3(s.v0x, s.v0y, s.v0z, k);
  const Vec e1 = ld3(s.e1x, s.e1y, s.e1z, k);
  const Vec e2 = ld3(s.e2x, s.e2y, s.e2z, k);
  const Vec pvec = cross3(d, e2);
  const float det = dot3(e1, pvec);
  bool ok = fabsf(det) >= 1e-12f;
  const float idet = 1.0f / (ok ? det : 1.0f);
  const Vec tvec = sub(o, v0);
  const float uu = dot3(tvec, pvec) * idet;
  const Vec qvec = cross3(tvec, e1);
  const float vv = dot3(d, qvec) * idet;
  const float tt = dot3(e2, qvec) * idet;
  ok = ok & (uu >= 0.0f) & (uu <= 1.0f) & (vv >= 0.0f) &
       (uu + vv <= 1.0f) & (tt >= 0.0f);
  *t = tt;
  *u = uu;
  *v = vv;
  return ok;
}

__device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(128)
bvh_bitstack_kernel(const float* __restrict__ ox,
                    const float* __restrict__ oy,
                    const float* __restrict__ oz,
                    const float* __restrict__ dx,
                    const float* __restrict__ dy,
                    const float* __restrict__ dz,
                    const float* __restrict__ tmax, Scene s,
                    float* __restrict__ out_t, int* __restrict__ out_tri,
                    float* __restrict__ out_u, float* __restrict__ out_v,
                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Vec o{ox[i], oy[i], oz[i]};
  const Vec d{dx[i], dy[i], dz[i]};
  const Vec inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  float t = tmax[i], u = 0.0f, v = 0.0f;
  int tri = -1;
  int top = 0;
  uint64_t ls = 0, rs = 0;   // the left / right bitstacks, bit 0 = level
  bool backtrack = false;
  for (;;) {
    const int topc = clampi(top, 0, s.n_nodes - 1);
    const int np = __ldg(s.nprims + topc);
    const int ros = __ldg(s.ros + topc);
    if (!backtrack) {
      if (np > 0) {
        // leaf: its triangles in the order of indices, first of equal t
        bool occluded = false;
        const int m = np < s.max_leaf ? np : s.max_leaf;
        for (int j = 0; j < m; ++j) {
          const int k = __ldg(s.indices + clampi(ros + j, 0, s.n_idx - 1));
          float tt, uu, vv;
          const bool ok = tri_hit(s, k, o, d, &tt, &uu, &vv);
          if (ok & (tt > 0.0f) & (tt < t)) {
            if (ANY_HIT) {
              occluded = true;
              break;
            }
            t = tt;
            tri = k;
            u = uu;
            v = vv;
          }
        }
        if (ANY_HIT && occluded) {
          tri = 1;
          break;
        }
        backtrack = true;
      } else {
        // inner: both children's boxes, the near one first (left on a tie)
        const int li = topc + 1;
        const int ri = clampi(ros, 0, s.n_nodes - 1);
        float lt, rt;
        const bool lhit = box_hit(s, li, o, inv, t, &lt);
        const bool rhit = box_hit(s, ri, o, inv, t, &rt);
        const bool left_first = lt <= rt;
        if (lhit & rhit) {
          if (left_first) ls |= 1;
          else rs |= 1;
        }
        if (lhit | rhit) {
          top = (lhit & (!rhit | left_first)) ? li : ri;
          ls <<= 1;
          rs <<= 1;
        } else {
          backtrack = true;
        }
      }
    } else {
      if ((ls | rs) == 0) break;
      if (ls & 1) {                 // the right sibling is still to visit
        top = clampi(ros, 0, s.n_nodes - 1);
        ls = (ls & ~1ull) << 1;
        rs <<= 1;
        backtrack = false;
      } else if (rs & 1) {          // the left sibling is still to visit
        top = topc + 1;
        rs = (rs & ~1ull) << 1;
        ls <<= 1;
        backtrack = false;
      } else {                      // up one level
        top = __ldg(s.parent + topc);
        ls >>= 1;
        rs >>= 1;
      }
    }
  }
  out_t[i] = t;
  out_tri[i] = tri;
  out_u[i] = u;
  out_v[i] = v;
}

extern "C" int bvh_bitstack_launch(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmax, const float* bminx,
    const float* bminy, const float* bminz, const float* bmaxx,
    const float* bmaxy, const float* bmaxz, const float* v0x,
    const float* v0y, const float* v0z, const float* e1x, const float* e1y,
    const float* e1z, const float* e2x, const float* e2y, const float* e2z,
    const int* ros, const int* parent, const int* nprims, const int* indices,
    float* out_t, int* out_tri, float* out_u, float* out_v, int n,
    int n_nodes, int n_idx, int max_leaf, int any_hit, void* stream) {
  if (n == 0) return 0;
  const Scene s{bminx, bminy, bminz, bmaxx, bmaxy, bmaxz, v0x,   v0y,
                v0z,   e1x,   e1y,   e1z,   e2x,   e2y,   e2z,   ros,
                parent, nprims, indices, n_nodes, n_idx, max_leaf};
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (any_hit)
    bvh_bitstack_kernel<true><<<blocks, threads, 0, st>>>(
        ox, oy, oz, dx, dy, dz, tmax, s, out_t, out_tri, out_u, out_v, n);
  else
    bvh_bitstack_kernel<false><<<blocks, threads, 0, st>>>(
        ox, oy, oz, dx, dy, dz, tmax, s, out_t, out_tri, out_u, out_v, n);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING
