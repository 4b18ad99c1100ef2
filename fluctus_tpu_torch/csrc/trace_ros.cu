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
// transforms are the only bytes read.
//
// Design: K2's — one CTA per tile, one thread per ray, t_best / i_best in
// registers, the live vote by __syncthreads_or, the cluster staged once into
// shared memory, a block max-reduce for the early-out — with K2's slab test
// and sweep from common.cuh (the arithmetic is the same). Only the loads
// differ: each thread reads its ray's row of o4/d4, and the staging gathers
// the cluster's rows from tx/ty/tz.
#include "common.cuh"

template <bool ANY_HIT>
__global__ void trace_ros_kernel(const float* __restrict__ o4,
                                 const float* __restrict__ d4,
                                 const float* __restrict__ tm,
                                 const int* __restrict__ order,
                                 const float* __restrict__ cons,
                                 const float* __restrict__ tx,
                                 const float* __restrict__ ty,
                                 const float* __restrict__ tz,
                                 const float* __restrict__ boxes,
                                 float* __restrict__ t_out,
                                 int* __restrict__ i_out,
                                 int* __restrict__ visits, int rt,
                                 int ncl_pad, int n_clusters, int tc,
                                 long long m_pad) {
  extern __shared__ float sT[];   // [12][tc]
  __shared__ float sred[32];
  const size_t tile = blockIdx.x;
  const size_t ray = tile * rt + threadIdx.x;

  const Ray y = load_ray_rows(o4, d4, ray);
  float t_best = tm[ray];
  int i_best = -1;
  const int* ord = order + tile * ncl_pad;
  const float* cn = cons + tile * ncl_pad;
  int n_live = 0;

  float t_worst = block_max(t_best, sred);
  bool stop = (ord[0] < 0) || (cn[0] > t_worst) || (t_worst <= 0.0f);
  for (int slot = 0; slot < n_clusters && !stop; ++slot) {
    const int c = ord[slot];
    bool box_hit = slab_hit(boxes + (size_t)max(c, 0) * 8, y, t_best);
    if (ANY_HIT) box_hit = box_hit && (i_best < 0);
    const bool live = __syncthreads_or(box_hit) && (c >= 0);

    if (live) {
      ++n_live;
      stage_cluster_xyz(sT, tx, ty, tz, c, tc, m_pad);
      sweep_cluster<ANY_HIT>(sT, tc, c, y, t_best, i_best);
      __syncthreads();   // all sweeps done before sT is restaged
    }
    const int guard = min(slot + 1, n_clusters - 1);
    t_worst = block_max(t_best, sred);
    stop = (ord[guard] < 0) || (cn[guard] > t_worst) || (t_worst <= 0.0f);
  }
  t_out[ray] = t_best;
  i_out[ray] = i_best;
  if (threadIdx.x == 0) visits[tile] = n_live;
}

template <bool ANY_HIT>
static int launch(const float* o4, const float* d4, const float* tm,
                  const int* order, const float* cons, const float* tx,
                  const float* ty, const float* tz, const float* boxes,
                  float* t_out, int* i_out, int* visits, int nt, int rt,
                  int ncl_pad, int n_clusters, int tc, long long m_pad,
                  cudaStream_t s) {
  const size_t smem = sizeof(float) * 12 * (size_t)tc;
  cudaError_t e = cudaFuncSetAttribute(
      trace_ros_kernel<ANY_HIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  trace_ros_kernel<ANY_HIT><<<nt, rt, smem, s>>>(
      o4, d4, tm, order, cons, tx, ty, tz, boxes, t_out, i_out, visits, rt,
      ncl_pad, n_clusters, tc, m_pad);
  return (int)cudaGetLastError();
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
  return any_hit
             ? launch<true>(o4, d4, tm, order, cons, tx, ty, tz, boxes, t_out,
                            i_out, visits, nt, rt, ncl_pad, n_clusters, tc,
                            m_pad, s)
             : launch<false>(o4, d4, tm, order, cons, tx, ty, tz, boxes,
                             t_out, i_out, visits, nt, rt, ncl_pad,
                             n_clusters, tc, m_pad, s);
}

KERNEL_ERROR_STRING
