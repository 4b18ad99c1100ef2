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
// t_best, or that largest t_best is <= 0.
//
// Bound on the H100: FP32 operations. ~30 operations per (ray, triangle)
// pair of every visited cluster: sum over tiles of visited_clusters * tc *
// rt * 30. The rays, the candidate lists and the transforms of a visited
// cluster (12 KB at tc = 256) are the only bytes read.
//
// Design: one CTA per tile, one thread per ray, t_best / i_best in
// registers. `live` is decided with __syncthreads_or; the cluster's
// [12, tc] transform block is staged once into shared memory and read by
// every thread as a broadcast. The early-out reads a block max-reduce of
// t_best after each slot. Any-hit threads leave the sweep at their first
// blocking triangle and skip it once blocked (t_best = 0 admits nothing),
// which returns exactly the reference's min-then-compare result. The
// arithmetic is the reference's, operation for operation (-fmad=false);
// the slab test and the triangle sweep live in common.cuh, shared with K5.
#include "common.cuh"

template <bool ANY_HIT>
__global__ void trace_rol_kernel(const float* __restrict__ rays,
                                 const float* __restrict__ tm,
                                 const int* __restrict__ order,
                                 const float* __restrict__ cons,
                                 const float* __restrict__ t12,
                                 const float* __restrict__ boxes,
                                 float* __restrict__ t_out,
                                 int* __restrict__ i_out,
                                 int* __restrict__ visits, int rt,
                                 int ncl_pad, int n_clusters, int tc,
                                 long long m_pad) {
  extern __shared__ float sT[];   // [12][tc]
  __shared__ float sred[32];
  const int r = threadIdx.x;
  const size_t tile = blockIdx.x;

  const Ray y = load_ray(rays + tile * 8 * rt, rt, r);
  float t_best = tm[tile * rt + r];
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
      stage_cluster(sT, t12, c, tc, m_pad);
      sweep_cluster<ANY_HIT>(sT, tc, c, y, t_best, i_best);
      __syncthreads();   // all sweeps done before sT is restaged
    }
    const int guard = min(slot + 1, n_clusters - 1);
    t_worst = block_max(t_best, sred);
    stop = (ord[guard] < 0) || (cn[guard] > t_worst) || (t_worst <= 0.0f);
  }
  t_out[tile * rt + r] = t_best;
  i_out[tile * rt + r] = i_best;
  if (r == 0) visits[tile] = n_live;
}

extern "C" int trace_rol_launch(const float* rays, const float* tm,
                                const int* order, const float* cons,
                                const float* t12, const float* boxes,
                                float* t_out, int* i_out, int* visits, int nt,
                                int rt, int ncl_pad, int n_clusters, int tc,
                                long long m_pad, int any_hit, void* stream) {
  if (nt == 0) return 0;
  const size_t smem = sizeof(float) * 12 * (size_t)tc;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (any_hit) {
    e = cudaFuncSetAttribute(trace_rol_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    trace_rol_kernel<true><<<nt, rt, smem, s>>>(
        rays, tm, order, cons, t12, boxes, t_out, i_out, visits, rt, ncl_pad,
        n_clusters, tc, m_pad);
  } else {
    e = cudaFuncSetAttribute(trace_rol_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    trace_rol_kernel<false><<<nt, rt, smem, s>>>(
        rays, tm, order, cons, t12, boxes, t_out, i_out, visits, rt, ncl_pad,
        n_clusters, tc, m_pad);
  }
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING
