// K8 — per-lane read of a padded per-pixel table (the exact-spp path's
// per-path spp lookup).
//
// Replaces: fluctus_tpu/core/block_splat.py, _fetch_kernel (called by
// fetch).
//
//   out[i] = table[(i / s) * pk + local[i]]   for 0 <= local[i] < pk,
//            0 otherwise (the TPU kernel's compare-select gives 0 there)
// for the G groups of s lanes and pk padded pixels per group.
//
// Bound on the H100: memory. 4 B of local and 4 B of output per lane, plus
// the table entries the lanes read; at 1080p with 1M paths, under 13 MB.
//
// Design: one thread per lane, a direct gather. The TPU kernel built a
// [S, Pk] one-hot per group and reduced it, because Mosaic has no per-lane
// gather; Hopper has one.
#include "common.cuh"

__global__ void fetch_kernel(const int* __restrict__ local,
                             const float* __restrict__ table,
                             float* __restrict__ out, int n, int s, int pk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int l = local[i];
  out[i] = (l >= 0 && l < pk) ? table[(size_t)(i / s) * pk + l] : 0.0f;
}

extern "C" int fetch_launch(const int* local, const float* table, float* out,
                            int n, int s, int pk, void* stream) {
  if (n == 0) return 0;
  fetch_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      local, table, out, n, s, pk);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING
