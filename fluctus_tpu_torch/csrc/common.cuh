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

// Exported by every library so the Python side can name an error code.
#define KERNEL_ERROR_STRING                                        \
  extern "C" const char* kernel_error_string(int e) {              \
    return cudaGetErrorString(static_cast<cudaError_t>(e));        \
  }
