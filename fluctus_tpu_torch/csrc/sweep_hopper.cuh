// The Hopper sweep shared by the cluster traces: K2 (trace_rol.cu) and K9
// (trace_ros.cu), which walk a flat candidate list (walk_flat below), and
// K5 (trace_rol_sc.cu), which walks superclusters.
//
// The contract is the plain versions' (accel/mxu_trace.py _walk_plain),
// bit for bit: the same slab test, the same per-pair arithmetic in the
// reference's order of terms (-fmad=false), the same packed key and strict
// < update, the same any-hit verdict, the same candidate order, stop test
// and per-tile visit count.
//
// What differs is how the card gets there. A kernel picks its shape,
// Config<RAYS, SLICES, CLUSTER>, per mode:
//
// - RAYS rays per thread. Each triangle record read from shared memory
//   serves RAYS rays, whose divide chains are independent.
// - SLICES ray groups per CTA. Every group holds all rt rays (G = rt / RAYS
//   threads) and sweeps its slice of the triangles, so a tile has SLICES
//   times the warps that its rays alone would give: per-tile visit counts
//   are skewed (8x8 grid, segment 4: median 1, max 371), and the heaviest
//   tile's time on one SM bounds the launch.
// - CLUSTER CTAs per tile, one thread block cluster on as many SMs, each
//   sweeping its share of every visited cluster's triangles. The slices'
//   results meet in shared memory, across the cluster through distributed
//   shared memory, behind one barrier; every thread then holds the same
//   t_best / i_best as the others of its ray group, so every CTA takes the
//   same decisions.
// - Triangle records: a CTA stages its triangles as records of 12 floats,
//   [T0..T3 | T4..T7 | T8..T11], 48 bytes each: a triangle is three
//   broadcast float4 loads for RAYS rays instead of twelve scalar loads per
//   ray. cp.async 4-byte copies transpose the coefficient-major source into
//   records as they land (the global reads stay coalesced).
// - Two record buffers. While a cluster is swept, the next candidate that
//   the last vote left possibly live is fetched into the other buffer; a
//   fetch whose candidate turns out dead is dropped.
// - Few barriers. Between two sweeps no t_best or i_best changes, so every
//   decision until the next sweep (slab votes, the any-hit mask, max t_best
//   > 0, the stop test cons > t_worst) depends only on the state after the
//   last sweep. vote() decides up to 32 candidates and the block max of
//   t_best behind one barrier. t_best only falls and a ray once blocked
//   stays blocked, so a candidate that a vote found dead stays dead: after
//   a sweep only the candidates the last vote left live are tested again.
// - The validity test dz != 0 & t > 0 & u >= 0 & v >= 0 & (1-u)-v >= 0: a
//   comparison with NaN is false and min(u, v, w) >= 0 holds exactly when
//   each of u, v, w >= 0, so it equals the reference's
//   min(min(u, v), 1-u-v) >= 0 for every input, without NaN checks.
// - tc is a constant (256, the cluster size of every table), so the
//   staging indexes with shifts and the triangle loop unrolls.
#pragma once
#include <cooperative_groups.h>

#include "common.cuh"

namespace hs {

namespace cg = cooperative_groups;

constexpr int WINDOW = 32;    // candidates decided by one vote
constexpr int TC = 256;       // triangles per cluster
constexpr int MAX_RT = 512;   // rays per tile

template <int RAYS_, int SLICES_, int CLUSTER_>
struct Config {
  static constexpr int RAYS = RAYS_;        // rays per thread
  static constexpr int SLICES = SLICES_;    // ray groups per CTA
  static constexpr int CLUSTER = CLUSTER_;  // CTAs (SMs) per tile
  static constexpr int MAX_THREADS = MAX_RT / RAYS * SLICES;
  static constexpr int PER_CTA = TC / CLUSTER;        // triangles staged
  static constexpr int PER_SLICE = PER_CTA / SLICES;  // triangles swept

  // Threads of a CTA for a tile of rt rays, or 0 when rt does not split
  // into whole warps of RAYS rays per thread or exceeds MAX_RT.
  static int threads_for(int rt) {
    return (rt % (32 * RAYS) == 0 && rt <= MAX_RT) ? rt / RAYS * SLICES : 0;
  }
};

// Shared memory of one CTA: two record buffers; the slices' partial
// results, double-buffered (a CTA of the cluster may still read the last
// sweep's while this one writes the next); the vote's per-warp masks and
// maxima, double-buffered so that one barrier per vote suffices.
template <class C>
struct Shared {
  float4 rec[2][3 * TC];
  int part[2][C::SLICES][C::RAYS][MAX_RT / C::RAYS];
  unsigned mask[2][32];
  float tmax[2][32];
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The transforms as three [4, m_pad] row blocks: t12's rows 0-3, 4-7 and
// 8-11, or the x/y/z columns tx/ty/tz.
struct Source {
  const float* x;
  const float* y;
  const float* z;
  long long m_pad;
};

// One (ray, triangle) pair: t, and whether the hit is valid. The terms in
// the reference's order: oz = ((o0*T8 + o1*T9) + o2*T10) + T11, ...
__device__ __forceinline__ bool pair_hit(const Ray& y, const float4& A,
                                         const float4& B, const float4& C,
                                         float& t) {
  const float oz = y.o0 * C.x + y.o1 * C.y + y.o2 * C.z + C.w;
  const float dz = y.d0 * C.x + y.d1 * C.y + y.d2 * C.z;
  t = -oz / (dz == 0.0f ? 1.0f : dz);
  const float ox = y.o0 * A.x + y.o1 * A.y + y.o2 * A.z + A.w;
  const float dx = y.d0 * A.x + y.d1 * A.y + y.d2 * A.z;
  const float u = ox + t * dx;
  const float oy = y.o0 * B.x + y.o1 * B.y + y.o2 * B.z + B.w;
  const float dy = y.d0 * B.x + y.d1 * B.y + y.d2 * B.z;
  const float v = oy + t * dy;
  return (dz != 0.0f) & (t > 0.0f) & (u >= 0.0f) & (v >= 0.0f) &
         ((1.0f - u) - v >= 0.0f);
}

// The result of a vote: the candidates some ray enters (bit j for the
// j-th box), and the block max of t_best (fmaxf: a NaN lane is ignored, so
// t_worst > 0 reads "some t_best > 0").
struct Vote {
  unsigned mask;
  float t_worst;
};

// The per-tile state of a CTA: its rays, their t_best / i_best, the record
// buffers and which cluster the in-flight fetch holds. Thread x holds the
// rays g + r * G (r < RAYS) of ray group g = x % G, G = rt / RAYS, and
// sweeps slice x / G of the CTA's triangles.
template <class C, bool ANY_HIT>
struct Tile {
  static constexpr int RAYS = C::RAYS;
  Ray y[RAYS];
  float t_best[RAYS];
  int i_best[RAYS];
  Shared<C>& sh;
  const Source src;
  const int G;        // ray groups
  const int g;        // this thread's ray group
  const int slice;    // this thread's slice of the CTA's triangles
  const int rank;     // this CTA's rank in the tile's cluster
  int parity = 0;     // which half of sh.mask / sh.tmax the next vote uses
  int ppart = 0;      // which half of sh.part the next sweep uses
  int fetched = -1;   // cluster in flight to sh.rec[fetched_buf], or -1
  int fetched_buf = 0;
  int n_live = 0;

  __device__ Tile(Shared<C>& s, const Source& source)
      : sh(s),
        src(source),
        G(blockDim.x / C::SLICES),
        g(threadIdx.x % (blockDim.x / C::SLICES)),
        slice(threadIdx.x / (blockDim.x / C::SLICES)),
        rank(C::CLUSTER > 1 ? (int)cg::this_cluster().block_rank() : 0) {}

  // The tile this CTA works on.
  __device__ __forceinline__ static size_t tile() {
    return blockIdx.x / C::CLUSTER;
  }

  // Index within the tile of ray r of this thread.
  __device__ __forceinline__ int lane(int r) const { return g + r * G; }

  // Whether this thread writes the tile's outputs (one per ray).
  __device__ __forceinline__ bool writer() const {
    return slice == 0 && rank == 0;
  }

  // Barrier of every thread of the tile: the cluster's, or the CTA's.
  __device__ __forceinline__ void tile_sync() const {
    if (C::CLUSTER > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }

  // Start copying this CTA's triangles of cluster c into the records
  // `rec`: row k of the [12, m_pad] source lands at float k of record j.
  __device__ __forceinline__ void stage(float4* rec, int c) const {
    float* dst = reinterpret_cast<float*>(rec);
    const int j0 = rank * C::PER_CTA;
    const long long base = (long long)c * TC + j0;
    for (int e = threadIdx.x; e < 12 * C::PER_CTA; e += blockDim.x) {
      const int k = e / C::PER_CTA, j = e % C::PER_CTA;
      const float* row = k < 4 ? src.x : (k < 8 ? src.y : src.z);
      cp_async4(dst + (j0 + j) * 12 + k,
                row + (k & 3) * src.m_pad + base + j);
    }
    cp_async_commit();
  }

  // Decide the candidates of `bits` (bit j: the box box_of(j)) for every
  // ray of the tile, and the block max of t_best, behind one CTA barrier.
  // Every thread must call it, with the same bits. Lane j of each warp
  // loads box j, so the window's boxes arrive in one memory latency, and
  // the warp reads them by shuffles. The slices share the candidates out
  // (each slice holds every ray): slice q % SLICES tests the q-th.
  template <class BoxOf>
  __device__ __forceinline__ Vote vote(unsigned bits, BoxOf box_of) {
    const int lane_id = threadIdx.x & 31;
    float mine[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if ((bits >> lane_id) & 1u) {
      const float* p = box_of(lane_id);
#pragma unroll
      for (int k = 0; k < 6; ++k) mine[k] = p[k];
    }
    unsigned m = 0;
    int q = 0;
    for (unsigned b = bits; b; b &= b - 1, ++q) {
      if (q % C::SLICES != slice) continue;
      const int j = __ffs(b) - 1;
      float box[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) box[k] = __shfl_sync(FULL_MASK, mine[k], j);
      bool hit = false;
#pragma unroll
      for (int r = 0; r < RAYS; ++r) {
        bool h = slab_hit(box, y[r], t_best[r]);
        if (ANY_HIT) h = h && (i_best[r] < 0);
        hit = hit || h;
      }
      if (__any_sync(FULL_MASK, hit)) m |= 1u << j;
    }
    float mx = t_best[0];
#pragma unroll
    for (int r = 1; r < RAYS; ++r) mx = fmaxf(mx, t_best[r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
    const int w = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      sh.mask[parity][w] = m;
      sh.tmax[parity][w] = mx;
    }
    __syncthreads();
    Vote v{sh.mask[parity][0], sh.tmax[parity][0]};
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k) {
      v.mask |= sh.mask[parity][k];
      v.t_worst = fmaxf(v.t_worst, sh.tmax[parity][k]);
    }
    parity ^= 1;
    return v;
  }

  // Sweep cluster c (a live candidate) for every ray, fetching `next`
  // (a cluster, or -1) meanwhile. Every thread of the tile must call it.
  // The CTA barrier after the copies land also tells every thread that the
  // other buffer (the last sweep's, or a dropped fetch's) is free.
  __device__ __forceinline__ void sweep(int c, int next) {
    int buf = fetched_buf;
    if (c != fetched) {   // not fetched ahead: copy now
      buf ^= 1;
      stage(sh.rec[buf], c);
    }
    cp_async_wait_all();
    __syncthreads();
    fetched = next;
    fetched_buf = buf ^ 1;
    if (next >= 0) stage(sh.rec[buf ^ 1], next);
    ++n_live;
    if (ANY_HIT)
      sweep_any(sh.rec[buf]);
    else
      sweep_closest(sh.rec[buf], c);
    ppart ^= 1;
  }

  // This thread's first triangle.
  __device__ __forceinline__ int first() const {
    return rank * C::PER_CTA + slice * C::PER_SLICE;
  }

  // Combine v over every slice of the tile (its own value first) with op,
  // through the shared (and distributed shared) memory of the cluster.
  template <class Op>
  __device__ __forceinline__ void combine(int (&v)[RAYS], Op op) {
    if (C::SLICES * C::CLUSTER == 1) return;   // one slice: v is whole
#pragma unroll
    for (int r = 0; r < RAYS; ++r) sh.part[ppart][slice][r][g] = v[r];
    tile_sync();
#pragma unroll
    for (int k = 0; k < C::CLUSTER; ++k) {
      Shared<C>* peer = &sh;
      if (C::CLUSTER > 1) peer = cg::this_cluster().map_shared_rank(&sh, k);
#pragma unroll
      for (int q = 0; q < C::SLICES; ++q) {
        if (q == slice && k == rank) continue;
#pragma unroll
        for (int r = 0; r < RAYS; ++r)
          v[r] = op(v[r], peer->part[ppart][q][r][g]);
      }
    }
  }

  // Closest hit: per ray the minimum packed key (bits(t) & ~(tc-1)) | row,
  // invalid -> 0x7F800000, over the slices' minima (a minimum in any
  // order); a strict tmin < t_best takes it.
  __device__ __forceinline__ void sweep_closest(const float4* rec, int c) {
    constexpr int rowbits = TC - 1;
    int kmin[RAYS];
#pragma unroll
    for (int r = 0; r < RAYS; ++r) kmin[r] = 0x7F800000;
    const int j0 = first();
#pragma unroll 2
    for (int j = j0; j < j0 + C::PER_SLICE; ++j) {
      const float4 A = rec[3 * j], B = rec[3 * j + 1], C4 = rec[3 * j + 2];
#pragma unroll
      for (int r = 0; r < RAYS; ++r) {
        float t;
        const bool valid = pair_hit(y[r], A, B, C4, t);
        const int key =
            valid ? ((__float_as_int(t) & ~rowbits) | j) : 0x7F800000;
        kmin[r] = min(kmin[r], key);
      }
    }
    combine(kmin, [](int a, int b) { return min(a, b); });
#pragma unroll
    for (int r = 0; r < RAYS; ++r) {
      const float tmin = __int_as_float(kmin[r] & ~rowbits);
      if (tmin < t_best[r]) {
        t_best[r] = tmin;
        i_best[r] = (kmin[r] & rowbits) + c * TC;
      }
    }
  }

  // Any hit: a ray is blocked (i = 1, t = 0) iff min over the cluster of
  // (valid ? t : F32_MAX) < t_best. Only a ray with t_best > 0 can be
  // blocked (valid needs t > 0; F32_MAX < t_best needs t_best > 0), so the
  // others are done from the start; a thread leaves its slice's loop once
  // all its rays are done. The slices' verdicts are ORed: a ray no slice
  // blocked was swept over every triangle, so its "some triangle invalid"
  // is complete, and past the loops only the F32_MAX of an invalid
  // triangle can still block it, which happens when t_best is +inf.
  __device__ __forceinline__ void sweep_any(const float4* rec) {
    bool done[RAYS], blocked[RAYS], invalid[RAYS];
    bool all = true;
#pragma unroll
    for (int r = 0; r < RAYS; ++r) {
      done[r] = !(t_best[r] > 0.0f);
      blocked[r] = invalid[r] = false;
      all = all && done[r];
    }
    const int j0 = first();
    for (int j = j0; j < j0 + C::PER_SLICE && !all; ++j) {
      const float4 A = rec[3 * j], B = rec[3 * j + 1], C4 = rec[3 * j + 2];
      all = true;
#pragma unroll
      for (int r = 0; r < RAYS; ++r) {
        float t;
        const bool valid = pair_hit(y[r], A, B, C4, t);
        blocked[r] = blocked[r] || (valid && t < t_best[r]);
        invalid[r] = invalid[r] || !valid;
        all = all && (done[r] || blocked[r]);
      }
    }
    int f[RAYS];
#pragma unroll
    for (int r = 0; r < RAYS; ++r) f[r] = blocked[r] | (invalid[r] << 1);
    combine(f, [](int a, int b) { return a | b; });
#pragma unroll
    for (int r = 0; r < RAYS; ++r) {
      if ((f[r] & 1) || ((f[r] & 2) && F32_MAX < t_best[r])) {
        i_best[r] = 1;
        t_best[r] = 0.0f;
      }
    }
  }

  // Before the CTA leaves: its copies landed, and no CTA of the cluster
  // reads its shared memory any more.
  __device__ __forceinline__ void finish() {
    cp_async_wait_all();
    if (C::CLUSTER > 1) cg::this_cluster().sync();
  }
};

// The bits of a window of n candidates (at most WINDOW).
__device__ __forceinline__ unsigned window_bits(int n) {
  return n >= WINDOW ? FULL_MASK : ((1u << n) - 1u);
}

// The bits of `mask` above bit j.
__device__ __forceinline__ unsigned bits_above(unsigned mask, int j) {
  return j >= 31 ? 0u : (mask & ~((2u << j) - 1u));
}

// The tile's stop test after slot g's predecessor: the -1 sentinel, an
// entry bound beyond the largest t_best, or no t_best > 0.
__device__ __forceinline__ bool stop_at(const int* ord, const float* cn,
                                        int g, float t_worst) {
  return (ord[g] < 0) || (cn[g] > t_worst) || (t_worst <= 0.0f);
}

// The flat walk of K2 and K9: a tile's candidate list ord / cn of n
// slots, -1 past the culled ones. Up to WINDOW slots are decided by one
// vote; a slot whose cluster some ray enters is swept (the next live slot
// fetched meanwhile) and the slots after it voted again. The tile stops at
// the -1 sentinel, when the next entry bound exceeds its largest t_best,
// or when that is <= 0. Every thread of the tile must call it.
template <class TileT>
__device__ __forceinline__ void walk_flat(TileT& T, const int* ord,
                                          const float* cn,
                                          const float* boxes, int n) {
  int base = 0;   // first slot of the voted window
  auto box_of = [&](int j) {
    return boxes + (size_t)max(ord[base + j], 0) * 8;
  };
  Vote v = T.vote(window_bits(n), box_of);
  unsigned live = v.mask;
  bool stop = stop_at(ord, cn, 0, v.t_worst);
  for (int slot = 0; slot < n && !stop; ++slot) {
    if (slot - base >= WINDOW) {
      base = slot;
      live = T.vote(window_bits(n - base), box_of).mask;
    }
    const int j = slot - base;
    const int c = ord[slot];
    if (((live >> j) & 1u) && c >= 0) {
      const unsigned rest = bits_above(live, j);
      const int next = rest ? ord[base + __ffs(rest) - 1] : -1;
      T.sweep(c, next);
      v = T.vote(rest, box_of);
      live = v.mask;
    }
    stop = stop_at(ord, cn, min(slot + 1, n - 1), v.t_worst);
  }
}

// The launch of a sweep kernel for nt tiles of rt rays: CLUSTER CTAs per
// tile as one thread block cluster. Returns the CUDA error; invalid value
// for a tile the shape does not take or a cluster size other than TC.
template <class C, class... Params, class... Args>
inline int launch(void (*kernel)(Params...), int nt, int rt, int tc,
                  cudaStream_t s, Args... args) {
  const int threads = C::threads_for(rt);
  if (threads == 0 || tc != TC) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nt * C::CLUSTER);
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Occupancy of a sweep kernel for a tile of rt rays: out[0] the tiles
// (clusters) the card holds at once, out[1] the CTAs per tile, out[2] the
// threads per CTA. Returns the CUDA error.
template <class C, class Kernel>
inline int occupancy(Kernel kernel, int rt, int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C::CLUSTER * 1024);
  cfg.blockDim = dim3(C::threads_for(rt));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  out[1] = C::CLUSTER;
  out[2] = C::threads_for(rt);
  return (int)cudaOccupancyMaxActiveClusters(&out[0], (void*)kernel, &cfg);
}

}  // namespace hs
