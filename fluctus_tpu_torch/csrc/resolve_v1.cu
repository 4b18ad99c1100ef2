// K10 — winner-attribute resolve from the f32 attrs table.
//
// Replaces: fluctus_tpu/accel/mxu_trace.py, _resolve_kernel (called by
// _resolve), the reference's resolve for tables that carry no B16 table.
//
// For each ray with a winner column col >= 0: the winner's f32 transform
// row txy_t[col] gives the exact t, u, v (resolve_common.cuh tuv, K3's
// order); its three vertex rows of attrs [3 Mpad, 40] — cluster c = col /
// tc holds v0 of its triangles in rows [3c tc, 3c tc + tc), then v1, then
// v2 — are interpolated column by column as ((1-u-v) a0 + u a1) + v a2,
// the baked material constants included (the reference's weighted one-hot
// product has exactly these three nonzero terms), and rows 26-28 become
// u, v, t. One column of the SoA [40, b] output per ray; misses get a zero
// column.
//
// Bound on the H100: memory. Per ray: the winner column (4 B), origin and
// direction (32 B) and the 160 B output column; per distinct winner three
// 160 B attribute rows and one 48 B transform row.
//
// Design: one thread per ray gathers its winner's rows directly (ten
// 16-byte loads per attribute row, three for the transform). The TPU
// kernel swept every cluster of the grid with one-hot matrix products only
// because Mosaic has no per-lane gather. The output is written in the
// port's SoA [40, b] layout, coalesced across the warp, in place of the
// reference's row-major [b, 40] and its transpose.
#include "resolve_common.cuh"

__global__ void resolve_v1_kernel(const int* __restrict__ col,
                                  const float4* __restrict__ o4,
                                  const float4* __restrict__ d4,
                                  const float4* __restrict__ txy,
                                  const float4* __restrict__ attrs,
                                  float* __restrict__ out, int b, int tc) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b) return;
  float* o = out + j;
  const int c = col[j];
  if (c < 0) {
    resolve::write_miss(o, b);
    return;
  }
  const float4* tr = txy + (size_t)c * 3;
  float t, u, v;
  resolve::tuv(o4[j], d4[j], tr[0], tr[1], tr[2], t, u, v);
  const float b0 = 1.0f - u - v;
  const int cl = c / tc;
  const size_t row = (size_t)cl * 3 * tc + (c - cl * tc);
  constexpr int Q = resolve::ATTR_COLS / 4;     // float4 per row
  const float4* a0 = attrs + row * Q;
  const float4* a1 = a0 + (size_t)tc * Q;
  const float4* a2 = a1 + (size_t)tc * Q;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float4 x = a0[q], y = a1[q], z = a2[q];
    float r[4] = {resolve::bary(b0, u, v, x.x, y.x, z.x),
                  resolve::bary(b0, u, v, x.y, y.y, z.y),
                  resolve::bary(b0, u, v, x.z, y.z, z.z),
                  resolve::bary(b0, u, v, x.w, y.w, z.w)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
      o[(size_t)k * b] = k == resolve::ATTR_HITU   ? u
                         : k == resolve::ATTR_HITV ? v
                         : k == resolve::ATTR_HITT ? t
                                                   : r[e];
    }
  }
}

extern "C" int resolve_v1_launch(const int* col, const float* o4,
                                 const float* d4, const float* txy_t,
                                 const float* attrs, float* out, int b,
                                 int tc, void* stream) {
  if (b == 0) return 0;
  const int threads = 256;
  resolve_v1_kernel<<<(b + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      col, reinterpret_cast<const float4*>(o4),
      reinterpret_cast<const float4*>(d4),
      reinterpret_cast<const float4*>(txy_t),
      reinterpret_cast<const float4*>(attrs), out, b, tc);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING
