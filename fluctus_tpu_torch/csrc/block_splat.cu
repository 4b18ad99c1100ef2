// K4 — dense per-group film splat (free-running, no spp cap).
//
// Replaces: fluctus_tpu/core/block_splat.py, _splat_kernel (called by
// splat with remaining=None).
//
//   out[ch, g*pk + p] = film[ch, g*pk + p]
//                       + sum over the group's lanes l (in lane order)
//                         with local[g*s + l] == p of data[ch, g*s + l]
// for the G groups of s lanes, pk padded pixels per group; local = -1
// means no splat.
//
// Bound on the H100: memory. Data (16 B) and local (4 B) per lane plus one
// read and one write of the [C, G*pk] film: about 90 MB per segment at
// 1080p with 1M paths.
//
// Design: one CTA per group. The group's local ids and data are staged in
// shared memory; each thread owns pixel columns and scans the group's lanes
// in lane order, summing into registers from 0 — a fixed order, so the
// result is deterministic (no float atomics) and equals the reference's
// segment sum. Then it adds the sum to the film once.
#include "common.cuh"

__global__ void block_splat_kernel(const int* __restrict__ local,
                                   const float* __restrict__ data,
                                   const float* __restrict__ film,
                                   float* __restrict__ out, int c, int n,
                                   int s, int pk) {
  extern __shared__ float smem[];
  int* sloc = reinterpret_cast<int*>(smem);   // [s]
  float* sdat = smem + s;                      // [c][s]
  const size_t g = blockIdx.x;
  const size_t npix = (size_t)gridDim.x * pk;
  for (int l = threadIdx.x; l < s; l += blockDim.x) {
    sloc[l] = local[g * s + l];
    for (int ch = 0; ch < c; ++ch) sdat[ch * s + l] = data[(size_t)ch * n + g * s + l];
  }
  __syncthreads();
  for (int p = threadIdx.x; p < pk; p += blockDim.x) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int l = 0; l < s; ++l) {
      if (sloc[l] == p) {
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
          if (ch < c) acc[ch] += sdat[ch * s + l];
      }
    }
    const size_t idx = g * pk + p;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      if (ch < c) out[ch * npix + idx] = film[ch * npix + idx] + acc[ch];
  }
}

extern "C" int block_splat_launch(const int* local, const float* data,
                                  const float* film, float* out, int c, int n,
                                  int groups, int s, int pk, void* stream) {
  if (groups == 0) return 0;
  if (c > 4) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)s * (1 + c);
  cudaError_t e = cudaFuncSetAttribute(
      block_splat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  block_splat_kernel<<<groups, 256, smem, (cudaStream_t)stream>>>(
      local, data, film, out, c, n, s, pk);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING
