// K1 — per-tile cluster entry bounds for the rays-on-lanes trace.
//
// Replaces: fluctus_tpu/accel/mxu_trace.py, _tile_order_kernel (called by
// _tile_order_v2).
//
// For every tile of rt rays and every cluster AABB c:
//   cons[tile, c] = min over the tile's rays of max(tnear, 0) over the rays
//                   whose exact slab test enters c within their tmax,
//                   else 1e30;
// padded with 1e30 up to ncl_pad (a multiple of 8). The wrapper sorts each
// tile's row into the front-to-back candidate list.
//
// Bound on the H100: operations. Each (ray, cluster) pair costs ~25 FP32
// operations (six subtract-multiply slabs, min/max, three compares) and
// reads nothing from device memory but the ray once; nt * ncl * rt * 25
// operations against 32 bytes a ray.
//
// Design: one CTA per tile, one thread per ray. The cluster boxes sit in
// shared memory (read by every thread, broadcast). Each cluster's minimum
// is reduced with warp shuffles into a [warps, ncl] shared array, then one
// thread per cluster folds the warps in a fixed order — deterministic, no
// atomics. The slab arithmetic is the reference's, term for term, with
// NaN-propagating min/max.
#include "common.cuh"

__global__ void tile_order_kernel(const float* __restrict__ rays,
                                  const float* __restrict__ tm,
                                  const float* __restrict__ boxes,
                                  float* __restrict__ cons, int rt, int ncl,
                                  int ncl_pad) {
  extern __shared__ float smem[];
  float* sbox = smem;              // [ncl][6]
  float* swmin = smem + ncl * 6;   // [nwarps][ncl]
  const int nwarps = blockDim.x >> 5;
  const int r = threadIdx.x;
  const int lane = r & 31, warp = r >> 5;
  const size_t tile = blockIdx.x;

  for (int k = r; k < ncl * 6; k += blockDim.x)
    sbox[k] = boxes[(k / 6) * 8 + (k % 6)];

  const float* R = rays + tile * 8 * rt;
  const float o0 = R[0 * rt + r], o1 = R[1 * rt + r], o2 = R[2 * rt + r];
  const float i0 = safe_inv(R[4 * rt + r]);
  const float i1 = safe_inv(R[5 * rt + r]);
  const float i2 = safe_inv(R[6 * rt + r]);
  const float tmax = tm[tile * rt + r];
  __syncthreads();

  for (int c = 0; c < ncl; ++c) {
    const float* b = sbox + c * 6;
    const float ax = (b[0] - o0) * i0;
    const float bx = (b[3] - o0) * i0;
    const float ay = (b[1] - o1) * i1;
    const float by = (b[4] - o1) * i1;
    const float az = (b[2] - o2) * i2;
    const float bz = (b[5] - o2) * i2;
    const float tnear = jmax(jmax(jmin(ax, bx), jmin(ay, by)), jmin(az, bz));
    const float tfar = jmin(jmin(jmax(ax, bx), jmax(ay, by)), jmax(az, bz));
    const bool hit = (tfar >= 0.0f) && (tnear <= tfar) && (tnear < tmax);
    float entry = hit ? fmaxf(tnear, 0.0f) : CULL_INF;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      entry = fminf(entry, __shfl_xor_sync(FULL_MASK, entry, off));
    if (lane == 0) swmin[warp * ncl + c] = entry;
  }
  __syncthreads();

  for (int c = r; c < ncl_pad; c += blockDim.x) {
    float m = CULL_INF;
    if (c < ncl)
      for (int w = 0; w < nwarps; ++w) m = fminf(m, swmin[w * ncl + c]);
    cons[tile * ncl_pad + c] = m;
  }
}

extern "C" int tile_order_launch(const float* rays, const float* tm,
                                 const float* boxes, float* cons, int nt,
                                 int rt, int ncl, int ncl_pad, void* stream) {
  if (nt == 0) return 0;
  const size_t smem = sizeof(float) * (size_t)ncl * (6 + rt / 32);
  cudaError_t e = cudaFuncSetAttribute(
      tile_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  tile_order_kernel<<<nt, rt, smem, (cudaStream_t)stream>>>(
      rays, tm, boxes, cons, rt, ncl, ncl_pad);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING
