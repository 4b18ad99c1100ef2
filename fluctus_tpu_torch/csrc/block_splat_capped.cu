// K7 — dense per-group film splat with the exact per-pixel spp cap.
//
// Replaces: fluctus_tpu/core/block_splat.py, _splat_kernel_capped (called
// by splat with remaining given).
//
// K4's function, with admission: a candidate (local[g*s + l] == p >= 0) is
// admitted iff its rank — the number of candidates for the same pixel in
// lower lanes of its group — is below remaining[g*pk + p], compared in f32
// as the reference does. Each pixel so takes exactly its first
// min(count, remaining) candidates in lane order:
//   out[ch, g*pk + p] = film[ch, g*pk + p]
//                       + sum over the admitted lanes l (in lane order)
//                         of data[ch, g*s + l]
//
// Bound on the H100: memory. Data (16 B) and local (4 B) per lane, the
// budget (4 B) per pixel, one read and one write of the [C, G*pk] film:
// about 96 MB per segment at 1080p with 1M paths.
//
// Design: K4's. One CTA per group stages the group's local ids and data in
// shared memory; each thread owns pixel columns and scans the group's lanes
// in lane order, counting its pixel's candidates as it goes, so the rank
// is a lane-ordered prefix count and the sum a fixed-order sum from 0. This
// takes the place of the TPU's strict-lower-triangular bf16 product, which
// existed because Mosaic has no prefix scan.
#include "common.cuh"

__global__ void block_splat_capped_kernel(const int* __restrict__ local,
                                          const float* __restrict__ data,
                                          const float* __restrict__ remaining,
                                          const float* __restrict__ film,
                                          float* __restrict__ out, int c,
                                          int n, int s, int pk) {
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
    const size_t idx = g * pk + p;
    const float rem = remaining[idx];
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int rank = 0;
    for (int l = 0; l < s; ++l) {
      if (sloc[l] == p) {
        if ((float)rank < rem) {
#pragma unroll
          for (int ch = 0; ch < 4; ++ch)
            if (ch < c) acc[ch] += sdat[ch * s + l];
        }
        ++rank;
      }
    }
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      if (ch < c) out[ch * npix + idx] = film[ch * npix + idx] + acc[ch];
  }
}

extern "C" int block_splat_capped_launch(const int* local, const float* data,
                                         const float* remaining,
                                         const float* film, float* out, int c,
                                         int n, int groups, int s, int pk,
                                         void* stream) {
  if (groups == 0) return 0;
  if (c > 4) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)s * (1 + c);
  cudaError_t e = cudaFuncSetAttribute(
      block_splat_capped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  block_splat_capped_kernel<<<groups, 256, smem, (cudaStream_t)stream>>>(
      local, data, remaining, film, out, c, n, s, pk);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING
