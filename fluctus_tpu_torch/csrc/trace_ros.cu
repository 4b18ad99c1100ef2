// K9 — rays-on-sublanes cluster trace, closest-hit and any-hit.
//
// Replaces: fluctus_tpu/accel/mxu_trace.py, _trace_kernel (called by
// _trace): the trace of the single-set entry points with FLT_SORT_RAYS=0
// (rays in lane order) and of the dispatch with FLT_ROL=0.
//
// K2's contract on the reference's own layouts: rays o4/d4 [b, 4] row-major
// (ox oy oz 1, dx dy dz 0), tmax [b, 1], per-tile order/cons [nt, ncl_pad]
// (K1 + sort), and the transforms as their x/y/z columns tx/ty/tz
// [4, m_pad]. One tile of rt rays walks its candidate list; per slot a
// per-ray slab cull with tfar >= 0 & tnear <= tfar & tnear < t_best (any-hit
// also drops blocked rays); if any ray of the tile enters the box (and the
// slot is a real cluster) every ray sweeps the cluster's tc triangles:
//   t = -oz/dz, u = ox + t*dx, v = oy + t*dy,
//   valid = dz != 0 & t > 0 & min(u, v, 1-u-v) >= 0,
// oz = o0*tz0 + o1*tz1 + o2*tz2 + tz3 (the reference's broadcast sums, in
// its order). Closest-hit keeps the minimum packed key
// (bits(t) & ~(tc-1)) | row (invalid -> 0x7F800000) with a strict
// tmin < t_best update, col = row + c*tc; any-hit sets i = 1, t = 0. The
// tile stops at the -1 sentinel, when the next entry bound exceeds its
// largest t_best, or when that is <= 0.
//
// Bound on the H100: FP32 operations, as K2: ~30 per (ray, triangle) pair
// of every visited cluster; the rays, candidate lists and visited clusters'
// transforms are the only bytes read. Under -fmad=false no multiply-add
// fuses, so the attainable rate is about half that bound. Lane-order tiles
// visit 4.5x more clusters than sorted ones, evenly (bounce 2 of the
// megastep: median 4, max 27 per tile), so K9 is bound by the sweep's
// instructions per pair: about 66 in the unrolled loop, 12 of them the
// IEEE divide.
//
// Design: sweep_hopper.cuh, whose flat walk (walk_flat) K2 shares on its
// own layouts. Closest-hit: one CTA of 256 threads per tile,
// 2 rays per thread (each triangle record serves two rays, two divides in
// flight); any-hit: 512 threads, one ray each, so a thread leaves the sweep
// at its ray's first blocking triangle. The cluster is staged by cp.async
// from tx/ty/tz into 48-byte triangle records, the next possibly-live
// cluster is fetched into a second buffer during the sweep, and up to 32
// slots are decided by one vote.
#include "sweep_hopper.cuh"

// Shapes, Config<rays per thread, ray groups per CTA, CTAs per tile>, the
// fastest of those timed on an H100 (PERF.md): closest-hit, any-hit.
using Closest = hs::Config<2, 1, 1>;
using AnyHit = hs::Config<1, 1, 1>;

template <class C, bool ANY_HIT>
__global__ void __launch_bounds__(C::MAX_THREADS)
    trace_ros_kernel(const float* __restrict__ o4,
                     const float* __restrict__ d4,
                     const float* __restrict__ tm,
                     const int* __restrict__ order,
                     const float* __restrict__ cons,
                     const float* __restrict__ tx,
                     const float* __restrict__ ty,
                     const float* __restrict__ tz,
                     const float* __restrict__ boxes,
                     float* __restrict__ t_out, int* __restrict__ i_out,
                     int* __restrict__ visits, int rt, int ncl_pad,
                     int n_clusters, long long m_pad) {
  using Tile = hs::Tile<C, ANY_HIT>;
  __shared__ hs::Shared<C> sh;
  Tile T(sh, hs::Source{tx, ty, tz, m_pad});
  const size_t tile = Tile::tile();
#pragma unroll
  for (int r = 0; r < C::RAYS; ++r) {
    const size_t ray = tile * rt + T.lane(r);
    T.y[r] = load_ray_rows(o4, d4, ray);
    T.t_best[r] = tm[ray];
    T.i_best[r] = -1;
  }
  hs::walk_flat(T, order + tile * ncl_pad, cons + tile * ncl_pad, boxes,
                n_clusters);
  if (T.writer()) {
#pragma unroll
    for (int r = 0; r < C::RAYS; ++r) {
      const size_t ray = tile * rt + T.lane(r);
      t_out[ray] = T.t_best[r];
      i_out[ray] = T.i_best[r];
    }
    if (threadIdx.x == 0) visits[tile] = T.n_live;
  }
  T.finish();
}

extern "C" int trace_ros_launch(const float* o4, const float* d4,
                                const float* tm, const int* order,
                                const float* cons, const float* tx,
                                const float* ty, const float* tz,
                                const float* boxes, float* t_out, int* i_out,
                                int* visits, int nt, int rt, int ncl_pad,
                                int n_clusters, int tc, long long m_pad,
                                int any_hit, void* stream) {
  if (nt == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit)
    return hs::launch<AnyHit>(trace_ros_kernel<AnyHit, true>, nt, rt, tc, s,
                              o4, d4, tm, order, cons, tx, ty, tz, boxes,
                              t_out, i_out, visits, rt, ncl_pad, n_clusters,
                              m_pad);
  return hs::launch<Closest>(trace_ros_kernel<Closest, false>, nt, rt, tc, s,
                             o4, d4, tm, order, cons, tx, ty, tz, boxes,
                             t_out, i_out, visits, rt, ncl_pad, n_clusters,
                             m_pad);
}

// Tiles in flight, CTAs per tile and threads per CTA (hs::occupancy).
extern "C" int trace_ros_occupancy(int any_hit, int rt, int* out) {
  return any_hit
             ? hs::occupancy<AnyHit>(trace_ros_kernel<AnyHit, true>, rt, out)
             : hs::occupancy<Closest>(trace_ros_kernel<Closest, false>, rt,
                                      out);
}

KERNEL_ERROR_STRING
