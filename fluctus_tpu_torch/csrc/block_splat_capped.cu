// K7 — dense per-group film splat with the exact per-pixel spp cap.
//
// Replaces: fluctus_tpu/core/block_splat.py, _splat_kernel_capped (called
// by splat with remaining given).
//
// K4's function, with admission: a candidate (local[g*s + l] == p, 0 <= p
// < pk) is admitted iff its rank — the number of candidates for the same
// pixel in lower lanes of its group — is below remaining[g*pk + p],
// compared in f32 as the reference does. Each pixel so takes exactly its
// first min(count, remaining) candidates in lane order:
//   out[ch, g*pk + p] = film[ch, g*pk + p]
//                       + sum over the admitted lanes l (in lane order)
//                         of data[ch, g*s + l]
//
// The stable counting sort per group of splat_sort.cuh, shared with K4,
// with each pixel's admitted prefix summed: bit-equal to
// splat_capped_plain.
#include "splat_sort.cuh"

__global__ void __launch_bounds__(ss::THREADS)
    block_splat_capped_kernel(const int* __restrict__ local,
                              const float* __restrict__ data,
                              const float* __restrict__ remaining,
                              const float* __restrict__ film,
                              float* __restrict__ out, int c, int n, int s,
                              int pk) {
  ss::splat_group<true, 4>(local, data, remaining, film, out, c, n, s,
                           pk);
}

extern "C" int block_splat_capped_launch(const int* local, const float* data,
                                         const float* remaining,
                                         const float* film, float* out, int c,
                                         int n, int groups, int s, int pk,
                                         void* stream) {
  if (groups == 0) return 0;
  if (c > 4) return (int)cudaErrorInvalidValue;
  const size_t smem = ss::smem_bytes(c, s, pk);
  cudaError_t e = cudaFuncSetAttribute(
      block_splat_capped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  block_splat_capped_kernel<<<groups, ss::THREADS, smem,
                              (cudaStream_t)stream>>>(
      local, data, remaining, film, out, c, n, s, pk);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING
