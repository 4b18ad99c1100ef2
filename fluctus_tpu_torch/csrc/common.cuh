// Helpers shared by the kernels of fluctus_tpu_torch/csrc.
//
// Compiled with -fmad=false (see kernel_build.py): every a*b+c below rounds
// twice, as the reference package's float32 arithmetic does.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define F32_MAX 3.4028235e38f
#define CULL_INF 1e30f
#define FULL_MASK 0xffffffffu

// NaN-propagating min/max (the semantics of jnp.minimum / jnp.maximum and
// torch.minimum / torch.maximum); fminf/fmaxf would drop a NaN operand.
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// Reciprocal of a direction component with the reference's zero guard.
__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (d == 0.0f ? 1e-30f : d);
}

// One ray of a trace tile: origin, direction, reciprocal direction.
struct Ray {
  float o0, o1, o2, d0, d1, d2, i0, i1, i2;
};

// The tile's rays are packed [8, rt]: ox oy oz 1 dx dy dz 0.
__device__ __forceinline__ Ray load_ray(const float* R, int rt, int r) {
  Ray y;
  y.o0 = R[0 * rt + r];
  y.o1 = R[1 * rt + r];
  y.o2 = R[2 * rt + r];
  y.d0 = R[4 * rt + r];
  y.d1 = R[5 * rt + r];
  y.d2 = R[6 * rt + r];
  y.i0 = safe_inv(y.d0);
  y.i1 = safe_inv(y.d1);
  y.i2 = safe_inv(y.d2);
  return y;
}

// One ray of the reference's row-major [b, 4] layouts: o = (ox oy oz 1),
// d = (dx dy dz 0) at row r.
__device__ __forceinline__ Ray load_ray_rows(const float* o4, const float* d4,
                                             size_t r) {
  Ray y;
  y.o0 = o4[4 * r + 0];
  y.o1 = o4[4 * r + 1];
  y.o2 = o4[4 * r + 2];
  y.d0 = d4[4 * r + 0];
  y.d1 = d4[4 * r + 1];
  y.d2 = d4[4 * r + 2];
  y.i0 = safe_inv(y.d0);
  y.i1 = safe_inv(y.d1);
  y.i2 = safe_inv(y.d2);
  return y;
}

// Exact per-ray slab test of the box b (bmin at b[0..2], bmax at b[3..5]):
// the ray enters it in front of the origin and before t_best.
__device__ __forceinline__ bool slab_hit(const float* b, const Ray& y,
                                         float t_best) {
  const float ax = (b[0] - y.o0) * y.i0;
  const float bx = (b[3] - y.o0) * y.i0;
  const float ay = (b[1] - y.o1) * y.i1;
  const float by = (b[4] - y.o1) * y.i1;
  const float az = (b[2] - y.o2) * y.i2;
  const float bz = (b[5] - y.o2) * y.i2;
  const float tnear = jmax(jmax(jmin(ax, bx), jmin(ay, by)), jmin(az, bz));
  const float tfar = jmin(jmin(jmax(ax, bx), jmax(ay, by)), jmax(az, bz));
  return (tfar >= 0.0f) && (tnear <= tfar) && (tnear < t_best);
}

// Block-wide max of v (fmaxf: a NaN lane is ignored). sred holds one
// float per warp; every thread of the block must call it.
__device__ __forceinline__ float block_max(float v, float* sred) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
  __syncthreads();   // the previous call's readers are done with sred
  if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = sred[0];
  const int nwarps = blockDim.x >> 5;
  for (int w = 1; w < nwarps; ++w) m = fmaxf(m, sred[w]);
  return m;
}

// Stage cluster c's [12, tc] transform block of t12 [12, m_pad] into
// shared memory (64-bit offsets), then wait for the whole block.
__device__ __forceinline__ void stage_cluster(float* sT, const float* t12,
                                              int c, int tc,
                                              long long m_pad) {
  const float* src = t12 + (long long)c * tc;
  for (int k = threadIdx.x; k < 12 * tc; k += blockDim.x)
    sT[k] = src[(long long)(k / tc) * m_pad + (k % tc)];
  __syncthreads();
}

// Stage cluster c's transforms from their x/y/z columns tx/ty/tz
// [4, m_pad] (rows of tx are t12's rows 0-3, ty's 4-7, tz's 8-11) into the
// same [12, tc] shared-memory block as stage_cluster, then wait for the
// whole block.
__device__ __forceinline__ void stage_cluster_xyz(
    float* sT, const float* tx, const float* ty, const float* tz, int c,
    int tc, long long m_pad) {
  const long long base = (long long)c * tc;
  for (int k = threadIdx.x; k < 12 * tc; k += blockDim.x) {
    const int row = k / tc;
    const float* src = row < 4 ? tx : (row < 8 ? ty : tz);
    sT[k] = src[(long long)(row & 3) * m_pad + base + (k % tc)];
  }
  __syncthreads();
}

// One ray against all tc triangles of the staged cluster c:
//   t = -oz/dz, u = ox + t*dx, v = oy + t*dy,
//   valid = dz != 0 & t > 0 & min(u, v, 1-u-v) >= 0.
// Closest hit keeps the minimum packed key (bits(t) & ~(tc-1)) | row
// (invalid -> 0x7F800000) and updates on a strict tmin < t_best, col =
// row + c*tc; t_best becomes the quantized key value. Any hit blocks the
// ray (i = 1, t = 0) iff min over the cluster of (valid ? t : F32_MAX) <
// t_best, the reference's verdict: at the first valid t < t_best it leaves
// early; past the loop only the F32_MAX of an invalid triangle can still
// be below t_best, which happens when t_best is +inf. A blocked ray
// (t_best = 0) admits nothing, so it skips the sweep.
template <bool ANY_HIT>
__device__ __forceinline__ void sweep_cluster(const float* sT, int tc, int c,
                                              const Ray& y, float& t_best,
                                              int& i_best) {
  const int rowbits = tc - 1;
  if (ANY_HIT) {
    if (i_best >= 0) return;
    bool any_invalid = false;
    for (int j = 0; j < tc; ++j) {
      const float* T = sT + j;
      const float oz = y.o0 * T[8 * tc] + y.o1 * T[9 * tc] +
                       y.o2 * T[10 * tc] + T[11 * tc];
      const float dz = y.d0 * T[8 * tc] + y.d1 * T[9 * tc] + y.d2 * T[10 * tc];
      const float t = -oz / (dz == 0.0f ? 1.0f : dz);
      const float ox = y.o0 * T[0] + y.o1 * T[tc] + y.o2 * T[2 * tc] +
                       T[3 * tc];
      const float dx = y.d0 * T[0] + y.d1 * T[tc] + y.d2 * T[2 * tc];
      const float u = ox + t * dx;
      const float oy = y.o0 * T[4 * tc] + y.o1 * T[5 * tc] +
                       y.o2 * T[6 * tc] + T[7 * tc];
      const float dy = y.d0 * T[4 * tc] + y.d1 * T[5 * tc] + y.d2 * T[6 * tc];
      const float v = oy + t * dy;
      const bool valid = (dz != 0.0f) && (t > 0.0f) &&
                         (jmin(jmin(u, v), 1.0f - u - v) >= 0.0f);
      if (valid && t < t_best) {
        i_best = 1;
        t_best = 0.0f;
        return;
      }
      any_invalid = any_invalid || !valid;
    }
    if (any_invalid && F32_MAX < t_best) {
      i_best = 1;
      t_best = 0.0f;
    }
  } else {
    int kmin = 0x7F800000;
    for (int j = 0; j < tc; ++j) {
      const float* T = sT + j;
      const float oz = y.o0 * T[8 * tc] + y.o1 * T[9 * tc] +
                       y.o2 * T[10 * tc] + T[11 * tc];
      const float dz = y.d0 * T[8 * tc] + y.d1 * T[9 * tc] + y.d2 * T[10 * tc];
      const float t = -oz / (dz == 0.0f ? 1.0f : dz);
      const float ox = y.o0 * T[0] + y.o1 * T[tc] + y.o2 * T[2 * tc] +
                       T[3 * tc];
      const float dx = y.d0 * T[0] + y.d1 * T[tc] + y.d2 * T[2 * tc];
      const float u = ox + t * dx;
      const float oy = y.o0 * T[4 * tc] + y.o1 * T[5 * tc] +
                       y.o2 * T[6 * tc] + T[7 * tc];
      const float dy = y.d0 * T[4 * tc] + y.d1 * T[5 * tc] + y.d2 * T[6 * tc];
      const float v = oy + t * dy;
      const bool valid = (dz != 0.0f) && (t > 0.0f) &&
                         (jmin(jmin(u, v), 1.0f - u - v) >= 0.0f);
      const int key =
          valid ? ((__float_as_int(t) & ~rowbits) | j) : 0x7F800000;
      kmin = min(kmin, key);
    }
    const float tmin = __int_as_float(kmin & ~rowbits);
    if (tmin < t_best) {
      t_best = tmin;
      i_best = (kmin & rowbits) + c * tc;
    }
  }
}

// Exported by every library so the Python side can name an error code.
#define KERNEL_ERROR_STRING                                        \
  extern "C" const char* kernel_error_string(int e) {              \
    return cudaGetErrorString(static_cast<cudaError_t>(e));        \
  }
