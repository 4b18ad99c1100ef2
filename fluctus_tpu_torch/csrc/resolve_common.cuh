// The winner-resolve arithmetic shared by K3 (resolve_v5.cu), K6
// (resolve_v5s.cu) and K10 (resolve_v1.cu).
//
// tuv: the exact t, u, v of a ray against its winner's affine transform
// (the x, y, z float4 of the transform row), in the reference's order.
// bary: ((1-u-v) a0 + u a1) + v a2, the barycentric interpolation both
// resolves use.
// epilogue: the reference's _b16_epilogue_t for one ray (K3, K6). Given
// the winner's B16 row (128 bf16, as 64 words w) and its transform,
// recompute t, u, v, sum the hi+lo floats, recombine the 8-bit chunks,
// interpolate the per-vertex normal and uv barycentrically, and write one
// column of the SoA [40, b] matrix (ATTR_* rows; map ids are stored +1 and
// come back -1). bf16 -> f32 is exact (bits << 16). Sums follow the
// reference's order.
#pragma once
#include "common.cuh"

namespace resolve {
// B16 column offsets (mxu_trace.B16)
constexpr int CF_HI = 24, CF_LO = 39, V0_HI = 54, V0_LO = 59,
              V1_HI = 64, V1_LO = 69, V2_HI = 74, V2_LO = 79, MAT = 84,
              TYPE = 86, MAP_KD = 88, MAP_KS = 90, MAP_N = 92, TRI = 94,
              TKD_W = 97, TKD_H = 99, TKD_OFF = 101, TKS_W = 104,
              TKS_H = 106, TKS_OFF = 108, TN_W = 111, TN_H = 113,
              TN_OFF = 115;
constexpr int ATTR_COLS = 40;
constexpr int ATTR_HITU = 26, ATTR_HITV = 27, ATTR_HITT = 28;

__device__ __forceinline__ float bf(const unsigned int* w, int i) {
  return __uint_as_float((i & 1) ? (w[i >> 1] & 0xFFFF0000u)
                                 : (w[i >> 1] << 16));
}
__device__ __forceinline__ float c2(const unsigned int* w, int a) {
  return bf(w, a) + bf(w, a + 1) * 256.0f;
}
__device__ __forceinline__ float c3(const unsigned int* w, int a) {
  return c2(w, a) + bf(w, a + 2) * 65536.0f;
}

// A miss: a zero column.
__device__ __forceinline__ void write_miss(float* o, int b) {
#pragma unroll
  for (int k = 0; k < ATTR_COLS; ++k) o[(size_t)k * b] = 0.0f;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void tuv(float4 O, float4 D, float4 tx,
                                    float4 ty, float4 tz, float& t,
                                    float& u, float& v) {
  const float oz = dot4(O, tz);
  const float dz = dot4(D, tz);
  t = -oz / (dz == 0.0f ? 1.0f : dz);
  const float ox = dot4(O, tx);
  const float dx = dot4(D, tx);
  const float oy = dot4(O, ty);
  const float dy = dot4(D, ty);
  u = ox + t * dx;
  v = oy + t * dy;
}

__device__ __forceinline__ float bary(float b0, float u, float v, float a0,
                                      float a1, float a2) {
  return b0 * a0 + u * a1 + v * a2;
}

// o points at the ray's column of the [40, b] output.
__device__ __forceinline__ void epilogue(const unsigned int* w, float4 O,
                                         float4 D, float4 tx, float4 ty,
                                         float4 tz, float* o, int b) {
  float t, u, v;
  tuv(O, D, tx, ty, tz, t, u, v);
  const float b0 = 1.0f - u - v;

#pragma unroll
  for (int k = 0; k < 5; ++k) {   // 0-4: N3, UV2
    const float v0 = bf(w, V0_HI + k) + bf(w, V0_LO + k);
    const float v1 = bf(w, V1_HI + k) + bf(w, V1_LO + k);
    const float v2 = bf(w, V2_HI + k) + bf(w, V2_LO + k);
    o[(size_t)k * b] = bary(b0, u, v, v0, v1, v2);
  }
  o[(size_t)5 * b] = c2(w, MAT);
#pragma unroll
  for (int k = 0; k < 15; ++k)    // 6-20: KD3 KS3 KE3 KT3 NS NI D
    o[(size_t)(6 + k) * b] = bf(w, CF_HI + k) + bf(w, CF_LO + k);
  o[(size_t)21 * b] = c2(w, TYPE);
  o[(size_t)22 * b] = c2(w, MAP_KD) - 1.0f;
  o[(size_t)23 * b] = c2(w, MAP_KS) - 1.0f;
  o[(size_t)24 * b] = c2(w, MAP_N) - 1.0f;
  o[(size_t)25 * b] = c3(w, TRI);
  o[(size_t)ATTR_HITU * b] = u;
  o[(size_t)ATTR_HITV * b] = v;
  o[(size_t)ATTR_HITT * b] = t;
  o[(size_t)29 * b] = c2(w, TKD_W) * 4096.0f + c2(w, TKD_H);
  o[(size_t)30 * b] = c3(w, TKD_OFF);
  o[(size_t)31 * b] = c2(w, TKS_W) * 4096.0f + c2(w, TKS_H);
  o[(size_t)32 * b] = c3(w, TKS_OFF);
  o[(size_t)33 * b] = c2(w, TN_W) * 4096.0f + c2(w, TN_H);
  o[(size_t)34 * b] = c3(w, TN_OFF);
#pragma unroll
  for (int k = 35; k < ATTR_COLS; ++k) o[(size_t)k * b] = 0.0f;
}
}  // namespace resolve
