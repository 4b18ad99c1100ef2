// K4 — dense per-group film splat (free-running, no spp cap).
//
// Replaces: fluctus_tpu/core/block_splat.py, _splat_kernel (called by
// splat with remaining=None; its callers pass 4 channels, the film, or 8,
// the denoiser's guide features).
//
//   out[ch, g*pk + p] = film[ch, g*pk + p]
//                       + sum over the group's lanes l (in lane order)
//                         with local[g*s + l] == p of data[ch, g*s + l]
//
// The stable counting sort per group of splat_sort.cuh with every
// candidate admitted: bit-equal to splat_plain. Two instances: up to 4
// channels (the film's path) and up to 8; the launcher picks by c.
#include "splat_sort.cuh"

template <int C>
__global__ void __launch_bounds__(ss::THREADS)
    block_splat_kernel(const int* __restrict__ local,
                       const float* __restrict__ data,
                       const float* __restrict__ film,
                       float* __restrict__ out, int c, int n, int s, int pk) {
  ss::splat_group<false, C>(local, data, nullptr, film, out, c, n, s, pk);
}

template <int C>
static int launch(const int* local, const float* data, const float* film,
                  float* out, int c, int n, int groups, int s, int pk,
                  cudaStream_t stream) {
  const size_t smem = ss::smem_bytes(c, s, pk);
  cudaError_t e = cudaFuncSetAttribute(
      block_splat_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  block_splat_kernel<C><<<groups, ss::THREADS, smem, stream>>>(
      local, data, film, out, c, n, s, pk);
  return (int)cudaGetLastError();
}

extern "C" int block_splat_launch(const int* local, const float* data,
                                  const float* film, float* out, int c, int n,
                                  int groups, int s, int pk, void* stream) {
  if (groups == 0) return 0;
  if (c < 1 || c > 8) return (int)cudaErrorInvalidValue;
  return c <= 4 ? launch<4>(local, data, film, out, c, n, groups, s, pk,
                            (cudaStream_t)stream)
                : launch<8>(local, data, film, out, c, n, groups, s, pk,
                            (cudaStream_t)stream);
}

KERNEL_ERROR_STRING
