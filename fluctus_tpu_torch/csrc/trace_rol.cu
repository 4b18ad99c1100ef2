// K2 — rays-on-lanes cluster trace, closest-hit and any-hit.
//
// Replaces: fluctus_tpu/accel/mxu_trace.py, _trace_kernel_rol (called by
// _trace_rol).
//
// One tile of rt rays walks its sorted candidate-cluster list (K1 + sort).
// Per candidate slot: a per-ray slab cull; if any ray of the tile enters
// the box (and the slot is a real cluster) every ray sweeps the cluster's
// tc triangles through their affine unit-triangle transforms:
//   t = -oz/dz, u = ox + t*dx, v = oy + t*dy,
//   valid = dz != 0 & t > 0 & min(u, v, 1-u-v) >= 0.
// Closest-hit keeps the minimum packed int32 key (bits(t) & ~(tc-1)) | row
// (invalid -> 0x7F800000) and updates on a strict tmin < t_best, col =
// row + c*tc; the returned t is the quantized key value. Any-hit sets
// i = 1, t = 0 once a valid t < t_best exists. The tile stops when the next
// slot is the -1 sentinel, its entry bound exceeds the tile's largest
// t_best, or that largest t_best is <= 0. Rays are packed per tile [8, rt]
// (ox oy oz 1 dx dy dz 0), the transforms are t12 [12, m_pad].
//
// Bound on the H100: FP32 operations. ~30 operations per (ray, triangle)
// pair of every visited cluster: sum over tiles of visited_clusters * tc *
// rt * 30. The rays, the candidate lists and the transforms of a visited
// cluster (12 KB at tc = 256) are the only bytes read. Under -fmad=false no
// multiply-add fuses, so the attainable rate is about half that bound.
// Sorted tiles visit few clusters, unevenly (luxball, segment 4: median 1,
// p99 13, max 27 per tile, 2,745 in 2,048 tiles), so the time is the
// heaviest tiles' visits plus each tile's fixed cost (ray loads, the first
// vote, the stop tests).
//
// Design: K9's walk (sweep_hopper.cuh, walk_flat) on K2's layouts: up to 32
// candidates decided by one vote, the cluster staged by cp.async into
// 48-byte triangle records, the next possibly live cluster fetched into a
// second buffer while the current one is swept. Closest-hit: a tile is a
// cluster of 2 CTAs of 256 threads, 2 rays per thread, each CTA sweeping
// half of every visited cluster's triangles, so a heavy tile's visits run
// on 2 SMs; any-hit: 2 CTAs of 512 threads, one ray each.
#include "sweep_hopper.cuh"

// Shapes, Config<rays per thread, ray groups per CTA, CTAs per tile>, the
// least worst-case loss over the calls sweep_shapes.py times on an H100
// (luxball segments 4 and 24, megastep bounce 2; PERF.md): closest-hit,
// any-hit.
using Closest = hs::Config<2, 1, 2>;
using AnyHit = hs::Config<1, 1, 2>;

template <class C, bool ANY_HIT>
__global__ void __launch_bounds__(C::MAX_THREADS)
    trace_rol_kernel(const float* __restrict__ rays,
                     const float* __restrict__ tm,
                     const int* __restrict__ order,
                     const float* __restrict__ cons,
                     const float* __restrict__ t12,
                     const float* __restrict__ boxes,
                     float* __restrict__ t_out, int* __restrict__ i_out,
                     int* __restrict__ visits, int rt, int ncl_pad,
                     int n_clusters, long long m_pad) {
  using Tile = hs::Tile<C, ANY_HIT>;
  __shared__ hs::Shared<C> sh;
  Tile T(sh, hs::Source{t12, t12 + 4 * m_pad, t12 + 8 * m_pad, m_pad});
  const size_t tile = Tile::tile();
#pragma unroll
  for (int r = 0; r < C::RAYS; ++r) {
    const int lane = T.lane(r);
    T.y[r] = load_ray(rays + tile * 8 * rt, rt, lane);
    T.t_best[r] = tm[tile * rt + lane];
    T.i_best[r] = -1;
  }
  hs::walk_flat(T, order + tile * ncl_pad, cons + tile * ncl_pad, boxes,
                n_clusters);
  if (T.writer()) {
#pragma unroll
    for (int r = 0; r < C::RAYS; ++r) {
      t_out[tile * rt + T.lane(r)] = T.t_best[r];
      i_out[tile * rt + T.lane(r)] = T.i_best[r];
    }
    if (threadIdx.x == 0) visits[tile] = T.n_live;
  }
  T.finish();
}

extern "C" int trace_rol_launch(const float* rays, const float* tm,
                                const int* order, const float* cons,
                                const float* t12, const float* boxes,
                                float* t_out, int* i_out, int* visits, int nt,
                                int rt, int ncl_pad, int n_clusters, int tc,
                                long long m_pad, int any_hit, void* stream) {
  if (nt == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit)
    return hs::launch<AnyHit>(trace_rol_kernel<AnyHit, true>, nt, rt, tc, s,
                              rays, tm, order, cons, t12, boxes, t_out, i_out,
                              visits, rt, ncl_pad, n_clusters, m_pad);
  return hs::launch<Closest>(trace_rol_kernel<Closest, false>, nt, rt, tc, s,
                             rays, tm, order, cons, t12, boxes, t_out, i_out,
                             visits, rt, ncl_pad, n_clusters, m_pad);
}

// Tiles in flight, CTAs per tile and threads per CTA (hs::occupancy).
extern "C" int trace_rol_occupancy(int any_hit, int rt, int* out) {
  return any_hit
             ? hs::occupancy<AnyHit>(trace_rol_kernel<AnyHit, true>, rt, out)
             : hs::occupancy<Closest>(trace_rol_kernel<Closest, false>, rt,
                                      out);
}

KERNEL_ERROR_STRING
