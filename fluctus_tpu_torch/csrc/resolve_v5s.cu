// K6 — winner-attribute resolve for tables past the resident budget.
//
// Replaces: fluctus_tpu/accel/mxu_trace.py, _resolve_kernel_v5s (called by
// _resolve_v5s), K3's contract for B16 tables the TPU could not keep in
// VMEM (it streamed each winner cluster's block HBM -> VMEM with
// double-buffered DMA).
//
// Computes K3's function, bit for bit — per ray with col >= 0 the
// winner's B16 row and transform row, then the shared epilogue
// (resolve_common.cuh); misses get a zero column.
//
// Bound on the H100: memory, as K3: per ray the column (4 B), the rays
// (32 B), one 256 B B16 row, 48 B of the transform row and a 160 B output
// column. The rows are the bulk, and past the 48 MiB switch (160.6 MiB at
// 361k triangles) they no longer fit the 50 MB L2: each winner row is a
// miss, read about once per segment.
//
// Design: the port's K3 already gathers each winner's row straight from
// device memory, so the TPU's resident/streamed split has no literal
// counterpart; what is left is the L2. One thread per ray reads its rows
// as 16-byte streaming loads (__ldcs, evict-first), so rows read once do
// not push out of L2 the pool arrays the logic phase reads next. Row
// offsets are 64-bit.
#include "resolve_common.cuh"

__global__ void resolve_v5s_kernel(const int* __restrict__ col,
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
  const float4* tr = t16r + (long long)c * 4;
  const float4 tx = __ldcs(tr), ty = __ldcs(tr + 1), tz = __ldcs(tr + 2);
  unsigned int w[64];
  const uint4* row = b16r + (long long)c * 16;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const uint4 v = __ldcs(row + q);
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
  resolve::epilogue(w, o4[j], d4[j], tx, ty, tz, o, b);
}

extern "C" int resolve_v5s_launch(const int* col, const float* o4,
                                  const float* d4, const uint16_t* b16r,
                                  const float* t16r, float* out, int b,
                                  void* stream) {
  if (b == 0) return 0;
  const int threads = 256;
  resolve_v5s_kernel<<<(b + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      col, reinterpret_cast<const float4*>(o4),
      reinterpret_cast<const float4*>(d4),
      reinterpret_cast<const uint4*>(b16r),
      reinterpret_cast<const float4*>(t16r), out, b);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING
