// K5 — two-level (supercluster) rays-on-lanes trace, closest-hit and
// any-hit.
//
// Replaces: fluctus_tpu/accel/mxu_trace.py, _trace_kernel_rol_sc (called
// by _trace_rol_sc).
//
// One tile of rt rays walks its sorted candidate list of SUPERCLUSTERS
// (K1 over sc_box + a stable sort). Per slot s: a per-ray slab test of the
// supercluster box against the current t_best (any-hit: unblocked rays
// only); if some ray of the tile enters it (and s is real), each member
// cluster c0 + k, k < cnt (sc_box columns 6, 7) gets its own slab cull
// against the updated t_best, live when some ray enters it and the tile's
// largest t_best is > 0. There is no early-out inside a supercluster. A
// live cluster is swept exactly as K2 sweeps one (common.cuh). After each
// slot the tile stops when the next slot is the -1 sentinel, its entry
// bound exceeds the tile's largest t_best, or that largest t_best is <= 0.
// Returns t, i per ray and the live member-cluster visits per tile.
//
// Bound on the H100: FP32 operations, as K2: ~30 operations per (ray,
// triangle) pair of every visited cluster, visits * tc * rt * 30. The
// per-member culls add ~20 operations per (ray, member) of every live
// supercluster; bytes are the rays, the lists and 12 KB of transforms per
// visit. Under -fmad=false no multiply-add fuses, so the attainable rate is
// about half that bound. What set K5's time was not the pair arithmetic but
// its spread: on the 8x8 grid's bounce rays the median tile visits 1
// cluster and the heaviest 371, so one tile on one SM ran for most of the
// launch; beside it, two block-wide votes per member of a live supercluster
// (51 members on average), a block max after every slot, and a synchronous
// 12 KB staging per visit.
//
// Design: sweep_hopper.cuh. Closest-hit: a tile is a cluster of 2 CTAs of
// 1024 threads (2 rays per thread, 4 ray groups per CTA), so each sweep of
// the heaviest tile runs on 2 SMs at 64 warps; any-hit, whose sweeps end
// at a ray's first blocking triangle, a cluster of 2 CTAs of 512 threads,
// one ray each. The members of a live
// supercluster are decided 32 at a time by one vote, and after a sweep
// only the members that vote left live are tested again (with the block
// max of t_best in the same barrier); the next possibly live member is
// fetched by cp.async into the second record buffer while the current one
// is swept. "max(t_best) > 0" is read as "some t_best > 0", the same
// predicate for the fmaxf block max. Offsets into t12 are 64-bit (Mpad =
// 526,336 at 361k triangles).
#include "sweep_hopper.cuh"

// Shapes, Config<rays per thread, ray groups per CTA, CTAs per tile>, the
// fastest of those timed on an H100 (PERF.md): closest-hit, any-hit.
using Closest = hs::Config<2, 4, 2>;
using AnyHit = hs::Config<1, 1, 2>;

template <class C, bool ANY_HIT>
__global__ void __launch_bounds__(C::MAX_THREADS)
    trace_rol_sc_kernel(const float* __restrict__ rays,
                        const float* __restrict__ tm,
                        const int* __restrict__ order,
                        const float* __restrict__ cons,
                        const float* __restrict__ t12,
                        const float* __restrict__ boxes,
                        const float* __restrict__ sc_box,
                        float* __restrict__ t_out, int* __restrict__ i_out,
                        int* __restrict__ visits, int rt, int nsc_pad,
                        long long m_pad) {
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
  const int* ord = order + tile * nsc_pad;
  const float* cn = cons + tile * nsc_pad;
  int base = 0;   // first slot of the voted supercluster window
  auto sc_of = [&](int j) {
    return sc_box + (size_t)max(ord[base + j], 0) * 8;
  };
  int c0 = 0, kb = 0;   // first member cluster, first member of the window
  auto member_of = [&](int j) { return boxes + (size_t)(c0 + kb + j) * 8; };

  hs::Vote v = T.vote(hs::window_bits(nsc_pad), sc_of);
  unsigned live = v.mask;
  float t_worst = v.t_worst;
  bool stop = hs::stop_at(ord, cn, 0, t_worst);
  for (int slot = 0; slot < nsc_pad && !stop; ++slot) {
    if (slot - base >= hs::WINDOW) {
      base = slot;
      live = T.vote(hs::window_bits(nsc_pad - base), sc_of).mask;
    }
    const int j = slot - base;
    const int s = ord[slot];
    bool swept = false;
    if (((live >> j) & 1u) && s >= 0) {
      const float* sb = sc_box + (size_t)s * 8;
      c0 = (int)sb[6];
      const int cnt = (int)sb[7];
      unsigned mlive = 0;
      kb = 0;
      for (int k = 0; k < cnt && t_worst > 0.0f;) {
        if (k == 0 || k - kb >= hs::WINDOW) {
          kb = k;
          mlive = T.vote(hs::window_bits(cnt - kb), member_of).mask;
        }
        const unsigned ahead = mlive >> (k - kb);
        if (!ahead) {
          k = kb + hs::WINDOW;
          continue;
        }
        k += __ffs(ahead) - 1;
        const unsigned rest = hs::bits_above(mlive, k - kb);
        T.sweep(c0 + k, rest ? c0 + kb + __ffs(rest) - 1 : -1);
        swept = true;
        v = T.vote(rest, member_of);
        mlive = v.mask;
        t_worst = v.t_worst;
        ++k;
      }
    }
    stop = hs::stop_at(ord, cn, min(slot + 1, nsc_pad - 1), t_worst);
    if (swept && !stop)   // the window's later votes are stale
      live = T.vote(hs::bits_above(live, j), sc_of).mask;
  }
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

extern "C" int trace_rol_sc_launch(const float* rays, const float* tm,
                                   const int* order, const float* cons,
                                   const float* t12, const float* boxes,
                                   const float* sc_box, float* t_out,
                                   int* i_out, int* visits, int nt, int rt,
                                   int nsc_pad, int tc, long long m_pad,
                                   int any_hit, void* stream) {
  if (nt == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit)
    return hs::launch<AnyHit>(trace_rol_sc_kernel<AnyHit, true>, nt, rt, tc,
                              s, rays, tm, order, cons, t12, boxes, sc_box,
                              t_out, i_out, visits, rt, nsc_pad, m_pad);
  return hs::launch<Closest>(trace_rol_sc_kernel<Closest, false>, nt, rt, tc,
                             s, rays, tm, order, cons, t12, boxes, sc_box,
                             t_out, i_out, visits, rt, nsc_pad, m_pad);
}

// Tiles in flight, CTAs per tile and threads per CTA (hs::occupancy).
extern "C" int trace_rol_sc_occupancy(int any_hit, int rt, int* out) {
  return any_hit ? hs::occupancy<AnyHit>(trace_rol_sc_kernel<AnyHit, true>,
                                         rt, out)
                 : hs::occupancy<Closest>(
                       trace_rol_sc_kernel<Closest, false>, rt, out);
}

KERNEL_ERROR_STRING
