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

// Exported by every library so the Python side can name an error code.
#define KERNEL_ERROR_STRING                                        \
  extern "C" const char* kernel_error_string(int e) {              \
    return cudaGetErrorString(static_cast<cudaError_t>(e));        \
  }
