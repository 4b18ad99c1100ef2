// K3 — winner-attribute resolve from the B16 table.
//
// Replaces: fluctus_tpu/accel/mxu_trace.py, _resolve_kernel_v5 with its
// epilogue _b16_epilogue_t (called by _resolve_v5).
//
// For each ray with a winner column col >= 0: fetch the winner's B16 row
// (bf16 hi/lo float pairs and 8-bit integer chunks, see mxu_trace.B16) and
// its exact float32 affine transform, then the reference epilogue
// (resolve_common.cuh) writes one column of the SoA [40, b] matrix. Misses
// get a zero column.
//
// Bound on the H100: memory. Per ray: the winner column (4 B), origin and
// direction (32 B), one 256 B table row and one 64 B transform row, and a
// 160 B output column — about 0.5 KB a ray.
//
// Design: one thread per ray reads its winner's row directly. The TPU
// kernel fetched rows with one-hot matrix products only because Mosaic has
// no per-lane gather; here the table is re-packed row-major on upload
// ([Mpad, 128] bf16 and [Mpad, 16] f32, from the same bits) so each row is
// sixteen 16-byte loads, and the output column writes are coalesced across
// the warp. Taken while the tables fit the reference's 48 MiB resident
// budget, which also leaves them room to stay in the 50 MB L2 across
// segments; past it, K6.
#include "resolve_common.cuh"

__global__ void resolve_v5_kernel(const int* __restrict__ col,
                                  const float4* __restrict__ o4,
                                  const float4* __restrict__ d4,
                                  const uint4* __restrict__ b16r,
                                  const float4* __restrict__ t16r,
                                  float* __restrict__ out, int b) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b) return;
  float* o = out + j;
  const int c = col[j];
  if (c < 0) {
    resolve::write_miss(o, b);
    return;
  }
  const float4* tr = t16r + (size_t)c * 4;
  unsigned int w[64];
  const uint4* row = b16r + (size_t)c * 16;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const uint4 v = row[q];
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
  resolve::epilogue(w, o4[j], d4[j], tr[0], tr[1], tr[2], o, b);
}

extern "C" int resolve_v5_launch(const int* col, const float* o4,
                                 const float* d4, const uint16_t* b16r,
                                 const float* t16r, float* out, int b,
                                 void* stream) {
  if (b == 0) return 0;
  const int threads = 256;
  resolve_v5_kernel<<<(b + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      col, reinterpret_cast<const float4*>(o4),
      reinterpret_cast<const float4*>(d4),
      reinterpret_cast<const uint4*>(b16r),
      reinterpret_cast<const float4*>(t16r), out, b);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING
