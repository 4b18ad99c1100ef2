// K1 — per-tile front-to-back candidate lists for every trace route.
//
// Replaces: fluctus_tpu/accel/mxu_trace.py, _tile_order_kernel and the
// lax.sort of _tile_order_v2 that follows it.
//
// For every tile of rt rays and every box c (clusters for K2 and K9,
// superclusters for K5):
//   bound[c] = min over the tile's rays of max(tnear, 0) over the rays
//              whose exact slab test enters c within their tmax,
//              else 1e30;
// padded with 1e30 up to ncl_pad (a multiple of 8); then the stable sort
// of the tile's bounds (ties by box index, lax.sort's order):
//   skey[tile, k]  = the k-th smallest bound,
//   order[tile, k] = its box index, or -1 where skey >= 1e30.
// Bit-equal to _candidate_order(tile_order_plain(...)).
//
// Bound on the H100: operations. Each (ray, box) pair costs ~25 FP32
// operations (six subtract-multiply slabs, ten min/max, three compares)
// and reads nothing from device memory but the ray once; nt * ncl * rt *
// 25 operations against 32 bytes a ray. Under -fmad=false nothing fuses.
//
// Design: one CTA per tile, RAYS_PER_THREAD rays per thread.
//   1. The boxes are staged in shared memory, each axis ordered low to
//      high, and read back as two broadcast float4 loads; each is tested
//      against the thread's rays, whose minimum is taken in registers.
//   2. The slab min/max are PTX min.NaN / max.NaN: one instruction each,
//      with the plain version's NaN propagation (a NaN term makes hit
//      false). Sorted tiles hold rays of one direction octant (the sort
//      key's top bits), so a warp whose rays share the sign bits of their
//      reciprocal directions knows each axis's near plane: min(a, b) is
//      the near term and max(a, b) the far one (lo <= hi, a positive
//      factor keeps the order; a NaN term still reaches tnear or tfar and
//      makes hit false). It picks the planes once per box (six selects)
//      and needs four min/max per pair instead of ten; other warps take
//      the plain version's ten.
//   3. Per (ray, box) one select, hit ? tnear : 1e30, and one min, folding
//      these into the thread's minimum over its rays. The plain
//      version's max(tnear, 0) (+0.0 for tnear <= 0, -0.0 included) is
//      taken once on that minimum (it commutes with the minimum), as
//      max(bits as int, 0). Non-negative floats order as their bits, so
//      the tile's minimum is an integer one: one __reduce_min_sync per
//      warp and box, one shared atomicMin per warp — exact in any order,
//      and no zero sign depends on the min/max instructions.
#include "common.cuh"

// Rays per thread, the fastest over the calls sweep_shapes.py times on an
// H100 (PERF.md); a tile of rt rays runs rt / RAYS_PER_THREAD threads. A
// tile that is not a multiple of 32 x that count takes the next smaller
// power of two.
constexpr int RAYS_PER_THREAD = 4;
static_assert(RAYS_PER_THREAD == 1 || RAYS_PER_THREAD == 2 ||
                  RAYS_PER_THREAD == 4 || RAYS_PER_THREAD == 8,
              "the launcher instantiates 1, 2, 4 and 8 rays per thread");
// Boxes per tile the shared memory holds: 32 bytes of box and 4 of bound
// each (147,456 bytes at the limit).
constexpr int MAX_BOXES = 4096;
constexpr unsigned CULL_BITS = 0x7149f2cau;   // 1e30f

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The thread's minimum over its rays' entries, max(., +0.0) on its bits,
// folded into the tile's bound of box c (step 3).
template <int R>
__device__ __forceinline__ void fold_bound(unsigned* sbound, int c,
                                           const float (&mk)[R]) {
  float m = mk[0];
#pragma unroll
  for (int k = 1; k < R; ++k) m = fminf(m, mk[k]);
  const unsigned e = (unsigned)max(__float_as_int(m), 0);
  const unsigned w = __reduce_min_sync(FULL_MASK, e);
  if ((threadIdx.x & 31) == 0) atomicMin(&sbound[c], w);
}

__device__ __forceinline__ unsigned sign_bit(float x) {
  return __float_as_uint(x) >> 31;
}

template <int R>
__global__ void __launch_bounds__(1024 / R)
    tile_order_kernel(const float* __restrict__ rays,
                      const float* __restrict__ tm,
                      const float4* __restrict__ boxes,
                      int* __restrict__ order, float* __restrict__ skey,
                      int rt, int ncl, int ncl_pad) {
  extern __shared__ float4 smem[];
  float4* sbox = smem;            // [ncl][2]: (x0 y0 z0 -), (x1 y1 z1 -)
  unsigned* sbound = reinterpret_cast<unsigned*>(sbox + 2 * ncl);  // [ncl_pad]
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;

  // 1. the boxes, each axis ordered low to high: the slab's per-axis
  // min/max are symmetric in the two planes, so the swap changes nothing
  // (NaN coordinates compare false and stay)
  for (int c = tid; c < ncl; c += nthreads) {
    const float4 p = boxes[2 * c], q = boxes[2 * c + 1];
    float lo[3] = {p.x, p.y, p.z}, hi[3] = {p.w, q.x, q.y};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      if (lo[a] > hi[a]) {
        const float t = lo[a];
        lo[a] = hi[a];
        hi[a] = t;
      }
    sbox[2 * c] = make_float4(lo[0], lo[1], lo[2], 0.0f);
    sbox[2 * c + 1] = make_float4(hi[0], hi[1], hi[2], 0.0f);
  }
  for (int c = tid; c < ncl_pad; c += nthreads)   // above every entry
    sbound[c] = c < ncl ? 0xffffffffu : CULL_BITS;

  // the thread's rays: lanes tid, tid + nthreads, ...; their octant, the
  // sign bits of the reciprocal directions
  const float* T = rays + tile * 8 * rt;
  float o0[R], o1[R], o2[R], i0[R], i1[R], i2[R], tmax[R];
  unsigned oct = 0;
  bool same = true;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = tid + k * nthreads;
    o0[k] = T[0 * rt + r];
    o1[k] = T[1 * rt + r];
    o2[k] = T[2 * rt + r];
    i0[k] = safe_inv(T[4 * rt + r]);
    i1[k] = safe_inv(T[5 * rt + r]);
    i2[k] = safe_inv(T[6 * rt + r]);
    tmax[k] = tm[tile * rt + r];
    const unsigned ok = sign_bit(i0[k]) | sign_bit(i1[k]) << 1 |
                        sign_bit(i2[k]) << 2;
    if (k == 0) oct = ok;
    same = same && ok == oct;
  }
  const unsigned oct0 = __shfl_sync(FULL_MASK, oct, 0);   // every lane
  const bool uniform = __all_sync(FULL_MASK, same && oct == oct0);
  __syncthreads();

  if (uniform) {
    // 2a. one octant for the warp's rays: the near plane of each axis is
    // known, min(a, b) is the near term and max(a, b) the far one
    const bool sx = oct & 1, sy = oct & 2, sz = oct & 4;
#pragma unroll 2
    for (int c = 0; c < ncl; ++c) {
      const float4 lo = sbox[2 * c], hi = sbox[2 * c + 1];
      const float nx = sx ? hi.x : lo.x, fx = sx ? lo.x : hi.x;
      const float ny = sy ? hi.y : lo.y, fy = sy ? lo.y : hi.y;
      const float nz = sz ? hi.z : lo.z, fz = sz ? lo.z : hi.z;
      float mk[R];   // per ray: no chain of dependent minima
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float tnear = max_nan(
            max_nan((nx - o0[k]) * i0[k], (ny - o1[k]) * i1[k]),
            (nz - o2[k]) * i2[k]);
        const float tfar = min_nan(
            min_nan((fx - o0[k]) * i0[k], (fy - o1[k]) * i1[k]),
            (fz - o2[k]) * i2[k]);
        const bool hit = tfar >= 0.0f && tnear <= tfar && tnear < tmax[k];
        mk[k] = hit ? tnear : CULL_INF;
      }
      fold_bound(sbound, c, mk);
    }
  } else {
    // 2b. rays of several octants: the plain version's terms in its order
#pragma unroll 2
    for (int c = 0; c < ncl; ++c) {
      const float4 lo = sbox[2 * c], hi = sbox[2 * c + 1];
      float mk[R];   // per ray: no chain of dependent minima
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float ax = (lo.x - o0[k]) * i0[k];
        const float bx = (hi.x - o0[k]) * i0[k];
        const float ay = (lo.y - o1[k]) * i1[k];
        const float by = (hi.y - o1[k]) * i1[k];
        const float az = (lo.z - o2[k]) * i2[k];
        const float bz = (hi.z - o2[k]) * i2[k];
        const float tnear = max_nan(
            max_nan(min_nan(ax, bx), min_nan(ay, by)), min_nan(az, bz));
        const float tfar = min_nan(
            min_nan(max_nan(ax, bx), max_nan(ay, by)), max_nan(az, bz));
        const bool hit = tfar >= 0.0f && tnear <= tfar && tnear < tmax[k];
        mk[k] = hit ? tnear : CULL_INF;
      }
      fold_bound(sbound, c, mk);
    }
  }
  __syncthreads();

  // 4. the stable rank sort, straight into the tile's row
  const size_t row = tile * ncl_pad;
  for (int i = tid; i < ncl_pad; i += nthreads) {
    const unsigned b = sbound[i];
    int rank = 0;
    for (int j = 0; j < i; ++j) rank += sbound[j] <= b;
    for (int j = i + 1; j < ncl_pad; ++j) rank += sbound[j] < b;
    const float key = __uint_as_float(b);
    skey[row + rank] = key;
    order[row + rank] = key >= CULL_INF ? -1 : i;
  }
}

template <int R>
static int launch(const float* rays, const float* tm, const float* boxes,
                  int* order, float* skey, int nt, int rt, int ncl,
                  int ncl_pad, cudaStream_t stream) {
  const size_t smem = 32 * (size_t)ncl + 4 * (size_t)ncl_pad;
  cudaError_t e = cudaFuncSetAttribute(
      tile_order_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  tile_order_kernel<R><<<nt, rt / R, smem, stream>>>(
      rays, tm, reinterpret_cast<const float4*>(boxes), order, skey, rt, ncl,
      ncl_pad);
  return (int)cudaGetLastError();
}

extern "C" int tile_order_launch(const float* rays, const float* tm,
                                 const float* boxes, int* order, float* skey,
                                 int nt, int rt, int ncl, int ncl_pad,
                                 void* stream) {
  if (rt % 32 || rt > 1024 || ncl > MAX_BOXES || ncl_pad < ncl ||
      ncl_pad % 8)
    return (int)cudaErrorInvalidValue;
  if (nt == 0 || ncl_pad == 0) return 0;
  int rpt = RAYS_PER_THREAD;
  while (rt % (32 * rpt)) rpt >>= 1;
  auto* fn = rpt == 8 ? launch<8> : rpt == 4 ? launch<4>
            : rpt == 2 ? launch<2> : launch<1>;
  return fn(rays, tm, boxes, order, skey, nt, rt, ncl, ncl_pad,
            (cudaStream_t)stream);
}

KERNEL_ERROR_STRING
