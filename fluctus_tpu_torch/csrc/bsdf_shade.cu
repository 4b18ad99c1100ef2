// bsdf_shade — the shade layer's BSDF work of one wavefront segment, one
// thread a lane: the NEE ray's bsdf and pdf, the continuation ray's lobe
// sample (three random draws) and the path's new throughput and origin.
//
// Replaces no Pallas kernel. The reference's BSDF dispatch
// (fluctus_tpu/bsdf/dispatch.py: bxdf_eval, bxdf_pdf, bxdf_sample) is jnp
// code, a masked superkernel that XLA fuses on the TPU: every lobe the
// scene holds runs over every lane and a select keeps each lane's own.
// Run eagerly by PyTorch, that superkernel is some 2,450 elementwise
// launches a segment on a scene of five lobes, and the host issuing them
// sets the segment's pace. Here each lane branches on its own type and
// runs its own lobe only, in one launch.
//
// The same function as bsdf_shade_plain (bsdf/dispatch.py), bit for bit
// against torch's CUDA kernels: each lobe in the torch code's order of
// terms, every torch operation one rounded IEEE operation (-fmad=false,
// -prec-div, -prec-sqrt), the libm calls torch's elementwise kernels make
// (sqrtf, rsqrtf, sinf, cosf, atan2f), and torch's CUDA forms of the
// operations with a Python number: x / c is x * (1 / c), c / x is
// reciprocal(x) * c, x ** 2 is x * x, clamp keeps a NaN. A lane whose type
// matches no lobe, or whose lobe the scene's type mask leaves out, gets
// what the masked selects give it: zeros.
//
// Bound on the H100: memory. Per lane 26 float32 streams, the type, the
// backface flag and the 8-byte seed in (117 B), 14 float32 streams and
// the seed out (64 B): 181 B, 190 MB at 1M lanes, 0.057 ms at 3.35 TB/s.
// The arithmetic, a few hundred FP32 operations and at most six
// transcendentals a lane, is far below 67 TFLOP/s.
//
// Design: one thread a lane, every stream read and written once in lane
// order (coalesced 4-byte accesses, streamed past the caches' keep
// lines), no shared memory. Lanes lie in ring order, so the lanes of a
// warp mostly share a material and take one branch. Every lobe inlined,
// the heaviest (the rough dielectric) sets 58 registers, no spills.

// The lobes, the rng and shade_lane live in bsdf_device.cuh, which
// surface_shade.cu includes too.
#include "bsdf_device.cuh"

namespace {

constexpr int THREADS = 256;

// The pointers, in bsdf_shade's order (bsdf/dispatch.py).
enum In {
  NX, NY, NZ, KDX, KDY, KDZ, KSX, KSY, KSZ, KEX, KEY, KEZ, ALPHA, NI,
  DIX, DIY, DIZ, LX, LY, LZ, TX, TY, TZ, PX, PY, PZ, N_IN
};
enum Out {
  EVX, EVY, EVZ, EPDF, DX, DY, DZ, PDF, NTX, NTY, NTZ, OX, OY, OZ, N_OUT
};

struct Args {
  const float* in[N_IN];
  const int* type;
  const unsigned char* backface;
  const long long* seed;
  float* out[N_OUT];
  long long* seed_out;
};

__device__ __forceinline__ V3 ld3(const Args& a, int c, int i) {
  return V3{__ldcs(a.in[c] + i), __ldcs(a.in[c + 1] + i),
            __ldcs(a.in[c + 2] + i)};
}
__device__ __forceinline__ void st3(const Args& a, int c, int i, V3 v) {
  __stcs(a.out[c] + i, v.x);
  __stcs(a.out[c + 1] + i, v.y);
  __stcs(a.out[c + 2] + i, v.z);
}

}  // namespace

// At global scope, as the other kernels, so that profilers name it
// bsdf_shade_kernel.
__global__ void __launch_bounds__(THREADS)
bsdf_shade_kernel(const Args a, int n, int st) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned long long seed =
      static_cast<unsigned long long>(__ldcs(a.seed + i));
  const Shade s = shade_lane(
      ld3(a, NX, i), ld3(a, KDX, i), ld3(a, KSX, i), ld3(a, KEX, i),
      __ldcs(a.in[ALPHA] + i), __ldcs(a.in[NI] + i), __ldcs(a.type + i),
      __ldcs(a.backface + i) != 0, ld3(a, DIX, i), ld3(a, LX, i), seed,
      ld3(a, TX, i), ld3(a, PX, i), st);
  st3(a, EVX, i, s.ev);
  __stcs(a.out[EPDF] + i, s.epdf);
  st3(a, DX, i, s.d);
  __stcs(a.out[PDF] + i, s.pdf);
  __stcs(a.seed_out + i, static_cast<long long>(seed));
  st3(a, NTX, i, s.T);
  st3(a, OX, i, s.orig);
}

// ptrs: the N_IN float inputs, type, backface and seed, then the N_OUT
// float outputs and the seed out (bsdf_shade's order).
extern "C" int bsdf_shade_launch(void* const* ptrs, int n, int scene_types,
                                 void* stream) {
  if (n == 0) return 0;
  Args a;
  int k = 0;
  for (int c = 0; c < N_IN; ++c)
    a.in[c] = static_cast<const float*>(ptrs[k++]);
  a.type = static_cast<const int*>(ptrs[k++]);
  a.backface = static_cast<const unsigned char*>(ptrs[k++]);
  a.seed = static_cast<const long long*>(ptrs[k++]);
  for (int c = 0; c < N_OUT; ++c)
    a.out[c] = static_cast<float*>(ptrs[k++]);
  a.seed_out = static_cast<long long*>(ptrs[k++]);
  const int blocks = (n + THREADS - 1) / THREADS;
  bsdf_shade_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      a, n, scene_types);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING
