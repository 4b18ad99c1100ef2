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
// visit.
//
// Design: K2's, one CTA of rt threads per tile, one thread per ray, t_best
// and i_best in registers, with the member loop inside the slot loop. The
// supercluster and member decisions are block-uniform (__syncthreads_or),
// so every thread walks the same members and the staged transform block
// is shared. "max(t_best) > 0" is read as "some t_best > 0", which is the
// same predicate for the fmaxf block max the early-out uses. Offsets into
// t12 are 64-bit (Mpad = 526,336 at 361k triangles).
#include "common.cuh"

template <bool ANY_HIT>
__global__ void trace_rol_sc_kernel(const float* __restrict__ rays,
                                    const float* __restrict__ tm,
                                    const int* __restrict__ order,
                                    const float* __restrict__ cons,
                                    const float* __restrict__ t12,
                                    const float* __restrict__ boxes,
                                    const float* __restrict__ sc_box,
                                    float* __restrict__ t_out,
                                    int* __restrict__ i_out,
                                    int* __restrict__ visits, int rt,
                                    int nsc_pad, int tc, long long m_pad) {
  extern __shared__ float sT[];   // [12][tc]
  __shared__ float sred[32];
  const int r = threadIdx.x;
  const size_t tile = blockIdx.x;

  const Ray y = load_ray(rays + tile * 8 * rt, rt, r);
  float t_best = tm[tile * rt + r];
  int i_best = -1;
  const int* ord = order + tile * nsc_pad;
  const float* cn = cons + tile * nsc_pad;
  int n_live = 0;

  float t_worst = block_max(t_best, sred);
  bool stop = (ord[0] < 0) || (cn[0] > t_worst) || (t_worst <= 0.0f);
  for (int slot = 0; slot < nsc_pad && !stop; ++slot) {
    const int s = ord[slot];
    const float* sb = sc_box + (size_t)max(s, 0) * 8;
    bool sc_hit = slab_hit(sb, y, t_best);
    if (ANY_HIT) sc_hit = sc_hit && (i_best < 0);
    const bool live_sc = __syncthreads_or(sc_hit) && (s >= 0);

    if (live_sc) {
      const int c0 = (int)sb[6];
      const int cnt = (int)sb[7];
      for (int k = 0; k < cnt; ++k) {
        const int c = c0 + k;
        bool hit = slab_hit(boxes + (size_t)c * 8, y, t_best);
        if (ANY_HIT) hit = hit && (i_best < 0);
        const bool live =
            __syncthreads_or(hit) && __syncthreads_or(t_best > 0.0f);
        if (live) {
          ++n_live;
          stage_cluster(sT, t12, c, tc, m_pad);
          sweep_cluster<ANY_HIT>(sT, tc, c, y, t_best, i_best);
          __syncthreads();   // all sweeps done before sT is restaged
        }
      }
    }
    const int guard = min(slot + 1, nsc_pad - 1);
    t_worst = block_max(t_best, sred);
    stop = (ord[guard] < 0) || (cn[guard] > t_worst) || (t_worst <= 0.0f);
  }
  t_out[tile * rt + r] = t_best;
  i_out[tile * rt + r] = i_best;
  if (r == 0) visits[tile] = n_live;
}

template <bool ANY_HIT>
static int launch(const float* rays, const float* tm, const int* order,
                  const float* cons, const float* t12, const float* boxes,
                  const float* sc_box, float* t_out, int* i_out, int* visits,
                  int nt, int rt, int nsc_pad, int tc, long long m_pad,
                  cudaStream_t s) {
  const size_t smem = sizeof(float) * 12 * (size_t)tc;
  cudaError_t e = cudaFuncSetAttribute(
      trace_rol_sc_kernel<ANY_HIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  trace_rol_sc_kernel<ANY_HIT><<<nt, rt, smem, s>>>(
      rays, tm, order, cons, t12, boxes, sc_box, t_out, i_out, visits, rt,
      nsc_pad, tc, m_pad);
  return (int)cudaGetLastError();
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
  return any_hit ? launch<true>(rays, tm, order, cons, t12, boxes, sc_box,
                                t_out, i_out, visits, nt, rt, nsc_pad, tc,
                                m_pad, s)
                 : launch<false>(rays, tm, order, cons, t12, boxes, sc_box,
                                 t_out, i_out, visits, nt, rt, nsc_pad, tc,
                                 m_pad, s);
}

KERNEL_ERROR_STRING
