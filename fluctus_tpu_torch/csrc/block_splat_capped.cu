// K7 — dense per-group film splat with the exact per-pixel spp cap.
//
// Replaces: fluctus_tpu/core/block_splat.py, _splat_kernel_capped (called
// by splat with remaining given).
//
// K4's function, with admission: a candidate (local[g*s + l] == p, 0 <= p
// < pk) is admitted iff its rank — the number of candidates for the same
// pixel in lower lanes of its group — is below remaining[g*pk + p],
// compared in f32 as the reference does. Each pixel so takes exactly its
// first min(count, remaining) candidates in lane order:
//   out[ch, g*pk + p] = film[ch, g*pk + p]
//                       + sum over the admitted lanes l (in lane order)
//                         of data[ch, g*s + l]
//
// Bound on the H100: memory. Data (16 B) and local (4 B) per lane, the
// budget (4 B) per pixel, one read and one write of the [C, G*pk] film:
// about 96 MB per segment at 1080p with 1M paths.
//
// Design: O(s + pk) work per group, a stable counting sort of the group's
// lanes by pixel. One CTA per group, one thread per lane (THREADS lanes per
// pass):
//   1. stage the group's data in shared memory;
//   2. count each pixel's candidates with shared integer atomics (an
//      integer sum, so their order does not matter);
//   3. an exclusive scan of the pk counts gives each pixel's first slot;
//   4. a lane's rank is the number of same-pixel lanes below it: within a
//      warp from __match_any_sync, across warps from per-warp per-pixel
//      counts summed in warp order, across passes from a running count;
//   5. each lane index goes to slot offset[p] + rank, so every pixel's
//      lanes lie in lane order;
//   6. each pixel's thread admits the first k of its candidates, k the
//      number of ranks r < count with (float)r < remaining (a prefix, as
//      (float)r grows with r), and sums their data from 0.0 in that order.
// The float additions are those of the plain version, in its order (its
// added 0.0 for a candidate past the budget leaves a sum started at +0.0
// unchanged), so the result is bit-equal to splat_capped_plain. The
// previous design scanned all s lanes for each of the pk pixels.
#include "common.cuh"

constexpr int THREADS = 256;          // lanes per pass, one per thread
constexpr int WARPS = THREADS / 32;

// Inclusive scan of a[0..n) in shared memory by the whole CTA: a
// contiguous run of items per thread, then the threads' totals scanned
// across the warp (shuffles) and the warps (wsum). The caller syncs after.
__device__ __forceinline__ void block_inclusive_scan(int* a, int n,
                                                     int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int per = (n + THREADS - 1) / THREADS;
  const int b = min(tid * per, n), e = min(b + per, n);
  int sum = 0;
  for (int i = b; i < e; ++i) {
    sum += a[i];
    a[i] = sum;
  }
  int x = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  int before = x - sum;
  for (int k = 0; k < w; ++k) before += wsum[k];
  for (int i = b; i < e; ++i) a[i] += before;
}

__global__ void __launch_bounds__(THREADS)
    block_splat_capped_kernel(const int* __restrict__ local,
                              const float* __restrict__ data,
                              const float* __restrict__ remaining,
                              const float* __restrict__ film,
                              float* __restrict__ out, int c, int n, int s,
                              int pk) {
  extern __shared__ int smem[];
  __shared__ int wsum[WARPS];
  int* off = smem;                    // [pk + 1]: counts, then first slots
  int* run = off + pk + 1;            // [pk]: candidates of earlier passes
  int* tbl = run + pk;                // [WARPS][pk]: this pass's per warp
  int* sorted = tbl + WARPS * pk;     // [s]: lane indices by pixel
  float* sdat = reinterpret_cast<float*>(sorted + s);   // [c][s]
  const size_t g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int* loc = local + g * s;

  // 1. stage the data; zero the counts and running counts
  for (int p = tid; p <= pk; p += THREADS) off[p] = 0;
  for (int p = tid; p < pk; p += THREADS) run[p] = 0;
  for (int l = tid; l < s; l += THREADS)
    for (int ch = 0; ch < c; ++ch)
      sdat[ch * s + l] = data[(size_t)ch * n + g * s + l];
  __syncthreads();

  // 2. count each pixel's candidates into off[p + 1]
  for (int l = tid; l < s; l += THREADS) {
    const int p = loc[l];
    if (p >= 0 && p < pk) atomicAdd(&off[p + 1], 1);
  }
  __syncthreads();

  // 3. off[p] = candidates of the pixels below p
  block_inclusive_scan(off + 1, pk, wsum);
  __syncthreads();

  // 4-5. ranks and the stable scatter, THREADS lanes per pass
  for (int l0 = 0; l0 < s; l0 += THREADS) {
    for (int e = tid; e < WARPS * pk; e += THREADS) tbl[e] = 0;
    __syncthreads();
    const int l = l0 + tid;
    const int p = l < s ? loc[l] : -1;
    const bool cand = p >= 0 && p < pk;
    const unsigned same = __match_any_sync(FULL_MASK, cand ? p : -1);
    const unsigned below = same & ((1u << lane) - 1u);
    const bool first = cand && below == 0;   // the warp's lowest on p
    if (first) tbl[w * pk + p] = __popc(same);
    __syncthreads();
    if (cand) {
      int rank = run[p] + __popc(below);
      for (int k = 0; k < w; ++k) rank += tbl[k * pk + p];
      sorted[off[p] + rank] = l;
    }
    __syncthreads();   // every lane of the pass has read run
    if (first) atomicAdd(&run[p], __popc(same));
  }
  __syncthreads();

  // 6. per pixel: the admitted prefix of its lanes, summed from 0.0
  const size_t npix = (size_t)gridDim.x * pk;
  for (int p = tid; p < pk; p += THREADS) {
    const size_t idx = g * pk + p;
    const float rem = remaining[idx];
    const int o = off[p], cnt = off[p + 1] - o;
    int k = 0;
    while (k < cnt && (float)k < rem) ++k;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < k; ++r) {
      const int ln = sorted[o + r];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
        if (ch < c) acc[ch] += sdat[ch * s + ln];
    }
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      if (ch < c) out[ch * npix + idx] = film[ch * npix + idx] + acc[ch];
  }
}

extern "C" int block_splat_capped_launch(const int* local, const float* data,
                                         const float* remaining,
                                         const float* film, float* out, int c,
                                         int n, int groups, int s, int pk,
                                         void* stream) {
  if (groups == 0) return 0;
  if (c > 4) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(int) * ((size_t)(pk + 1) + pk + (size_t)WARPS * pk + s +
                     (size_t)c * s);
  cudaError_t e = cudaFuncSetAttribute(
      block_splat_capped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  block_splat_capped_kernel<<<groups, THREADS, smem, (cudaStream_t)stream>>>(
      local, data, remaining, film, out, c, n, s, pk);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING
