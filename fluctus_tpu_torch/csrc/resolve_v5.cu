// K3 — winner-attribute resolve from the B16 table.
//
// Replaces: fluctus_tpu/accel/mxu_trace.py, _resolve_kernel_v5 with its
// epilogue _b16_epilogue_t (called by _resolve_v5).
//
// For each ray with a winner column col >= 0: fetch the winner's B16 row
// (bf16 hi/lo float pairs and 8-bit integer chunks, see mxu_trace.B16) and
// its exact float32 affine transform, recompute the exact t, u, v, sum the
// hi+lo floats, recombine the chunks, interpolate the per-vertex normal
// and uv barycentrically, and write one column of the SoA [40, b] matrix
// (ATTR_* rows; map ids are stored +1 and come back -1). Misses get a zero
// column.
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
// the warp. bf16 -> f32 is exact (bits << 16). The epilogue sums in the
// reference's order.
#include "common.cuh"

namespace {
// B16 column offsets (mxu_trace.B16)
constexpr int CF_HI = 24, CF_LO = 39, V0_HI = 54, V0_LO = 59,
              V1_HI = 64, V1_LO = 69, V2_HI = 74, V2_LO = 79, MAT = 84,
              TYPE = 86, MAP_KD = 88, MAP_KS = 90, MAP_N = 92, TRI = 94,
              TKD_W = 97, TKD_H = 99, TKD_OFF = 101, TKS_W = 104,
              TKS_H = 106, TKS_OFF = 108, TN_W = 111, TN_H = 113,
              TN_OFF = 115;
constexpr int ATTR_COLS = 40;
}  // namespace

#define BF(i) __uint_as_float(((i) & 1) ? (w[(i) >> 1] & 0xFFFF0000u) \
                                         : (w[(i) >> 1] << 16))
#define C2(a) (BF(a) + BF((a) + 1) * 256.0f)
#define C3(a) (C2(a) + BF((a) + 2) * 65536.0f)

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
#pragma unroll
    for (int k = 0; k < ATTR_COLS; ++k) o[(size_t)k * b] = 0.0f;
    return;
  }
  const float4 O = o4[j], D = d4[j];
  const float4 tx = t16r[(size_t)c * 4 + 0];
  const float4 ty = t16r[(size_t)c * 4 + 1];
  const float4 tz = t16r[(size_t)c * 4 + 2];
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

  const float oz = O.x * tz.x + O.y * tz.y + O.z * tz.z + O.w * tz.w;
  const float dz = D.x * tz.x + D.y * tz.y + D.z * tz.z + D.w * tz.w;
  const float t = -oz / (dz == 0.0f ? 1.0f : dz);
  const float ox = O.x * tx.x + O.y * tx.y + O.z * tx.z + O.w * tx.w;
  const float dx = D.x * tx.x + D.y * tx.y + D.z * tx.z + D.w * tx.w;
  const float oy = O.x * ty.x + O.y * ty.y + O.z * ty.z + O.w * ty.w;
  const float dy = D.x * ty.x + D.y * ty.y + D.z * ty.z + D.w * ty.w;
  const float u = ox + t * dx;
  const float v = oy + t * dy;
  const float b0 = 1.0f - u - v;

#pragma unroll
  for (int k = 0; k < 5; ++k) {   // 0-4: N3, UV2
    const float v0 = BF(V0_HI + k) + BF(V0_LO + k);
    const float v1 = BF(V1_HI + k) + BF(V1_LO + k);
    const float v2 = BF(V2_HI + k) + BF(V2_LO + k);
    o[(size_t)k * b] = b0 * v0 + u * v1 + v * v2;
  }
  o[(size_t)5 * b] = C2(MAT);
#pragma unroll
  for (int k = 0; k < 15; ++k)    // 6-20: KD3 KS3 KE3 KT3 NS NI D
    o[(size_t)(6 + k) * b] = BF(CF_HI + k) + BF(CF_LO + k);
  o[(size_t)21 * b] = C2(TYPE);
  o[(size_t)22 * b] = C2(MAP_KD) - 1.0f;
  o[(size_t)23 * b] = C2(MAP_KS) - 1.0f;
  o[(size_t)24 * b] = C2(MAP_N) - 1.0f;
  o[(size_t)25 * b] = C3(TRI);
  o[(size_t)26 * b] = u;
  o[(size_t)27 * b] = v;
  o[(size_t)28 * b] = t;
  o[(size_t)29 * b] = C2(TKD_W) * 4096.0f + C2(TKD_H);
  o[(size_t)30 * b] = C3(TKD_OFF);
  o[(size_t)31 * b] = C2(TKS_W) * 4096.0f + C2(TKS_H);
  o[(size_t)32 * b] = C3(TKS_OFF);
  o[(size_t)33 * b] = C2(TN_W) * 4096.0f + C2(TN_H);
  o[(size_t)34 * b] = C3(TN_OFF);
#pragma unroll
  for (int k = 35; k < ATTR_COLS; ++k) o[(size_t)k * b] = 0.0f;
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
