// The dense per-group film splat of K4 (block_splat.cu) and K7
// (block_splat_capped.cu): a stable counting sort of each group's lanes by
// pixel, then each pixel's lanes summed in lane order. c channels, at most
// the template's C: each thread keeps C values of a lane and of a pixel in
// registers. K4 is instantiated at C = 4 (the film: rgb + weight) and C = 8
// (the denoiser's guide features), K7 at C = 4.
//
//   out[ch, g*pk + p] = film[ch, g*pk + p]
//                       + sum over the group's lanes l (in lane order)
//                         with local[g*s + l] == p, admitted,
//                         of data[ch, g*s + l]
// for the G groups of s lanes, pk padded pixels per group; local = -1
// means no splat. K4 admits every candidate; K7 (CAPPED) admits a
// candidate iff its rank — the number of candidates for the same pixel in
// lower lanes of its group — is below remaining[g*pk + p], compared in f32
// as the reference does, so each pixel takes exactly its first
// min(count, remaining) candidates in lane order.
//
// Bound on the H100: memory. Data (4c B) and local (4 B) per lane, K7's
// budget (4 B) per pixel, one read and one write of the [c, G*pk] film:
// about 90 MB (K4 at 4 channels), 96 MB (K7) and 170 MB (K4 at 8
// channels) per segment at 1080p with 1M paths.
//
// Design: O(s + pk) work per group. One CTA per group, one thread per lane
// (THREADS lanes per pass):
//   1. stage the group's pixels and data in shared memory;
//   2. count each pixel's candidates with shared integer atomics (an
//      integer sum, so their order does not matter);
//   3. an exclusive scan of the pk counts gives each pixel's first slot;
//   4. a lane's rank is the number of same-pixel lanes below it: within a
//      warp from __match_any_sync, across warps from per-warp per-pixel
//      counts summed in warp order, across passes from a running count;
//   5. each lane index goes to slot offset[p] + rank, so every pixel's
//      lanes lie in lane order;
//   6. each pixel's thread takes the first k of its candidates — all of
//      them, or for K7 the number of ranks r < count with (float)r <
//      remaining (a prefix, as (float)r grows with r) — and sums their data
//      from 0.0 in that order.
// Step 1 issues every load of the group before it waits on any: its lanes'
// pixels and data, and the film (and K7's budgets) of each thread's first
// PRE pixels into registers, so their latency overlaps the sort.
// The float additions are those of the plain versions, in their order (K7's
// added 0.0 for a candidate past the budget leaves a sum started at +0.0
// unchanged), so the result is bit-equal to splat_plain and
// splat_capped_plain.
#pragma once
#include "common.cuh"

namespace ss {

constexpr int THREADS = 256;          // lanes per pass, one per thread
constexpr int WARPS = THREADS / 32;
constexpr int PRE = 2;                // pixels per thread loaded early

// Dynamic shared memory of one group, in bytes.
inline size_t smem_bytes(int c, int s, int pk) {
  return sizeof(int) * ((size_t)(pk + 1) + pk + (size_t)WARPS * pk +
                        2 * (size_t)s + (size_t)c * s);
}

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

// One group (blockIdx.x) of THREADS threads, c <= C channels; remaining
// is read only when CAPPED.
template <bool CAPPED, int C>
__device__ __forceinline__ void splat_group(
    const int* __restrict__ local, const float* __restrict__ data,
    const float* __restrict__ remaining, const float* __restrict__ film,
    float* __restrict__ out, int c, int n, int s, int pk) {
  extern __shared__ int smem[];
  __shared__ int wsum[WARPS];
  int* off = smem;                    // [pk + 1]: counts, then first slots
  int* run = off + pk + 1;            // [pk]: candidates of earlier passes
  int* tbl = run + pk;                // [WARPS][pk]: this pass's per warp
  int* sorted = tbl + WARPS * pk;     // [s]: lane indices by pixel
  int* sloc = sorted + s;             // [s]: the lanes' pixels
  float* sdat = reinterpret_cast<float*>(sloc + s);     // [c][s]
  const size_t g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const size_t npix = (size_t)gridDim.x * pk;

  // 1. the loads first, all in flight at once: the pixel and data of the
  // thread's first lane (the sort waits on them), then the film and
  // budgets of its first PRE pixels (only the sums wait on those)
  int p0 = -1;
  float v0[C] = {};
  if (tid < s) {
    p0 = local[g * s + tid];
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      if (ch < c) v0[ch] = data[(size_t)ch * n + g * s + tid];
  }
  float pre[PRE][C] = {}, pre_rem[PRE] = {};
#pragma unroll
  for (int q = 0; q < PRE; ++q) {
    const int p = tid + q * THREADS;
    if (p < pk) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        if (ch < c) pre[q][ch] = film[ch * npix + g * pk + p];
      if (CAPPED) pre_rem[q] = remaining[g * pk + p];
    }
  }
  // stage the lanes in shared memory; zero the counts and running counts
  for (int l = tid; l < s; l += THREADS) {
    int p = p0;
    float v[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = v0[ch];
    if (l != tid) {                   // lanes past the first pass
      p = local[g * s + l];
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        if (ch < c) v[ch] = data[(size_t)ch * n + g * s + l];
    }
    sloc[l] = p;
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      if (ch < c) sdat[ch * s + l] = v[ch];
  }
  for (int p = tid; p <= pk; p += THREADS) off[p] = 0;
  for (int p = tid; p < pk; p += THREADS) run[p] = 0;
  __syncthreads();

  // 2. count each pixel's candidates into off[p + 1]
  for (int l = tid; l < s; l += THREADS) {
    const int p = sloc[l];
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
    const int p = l < s ? sloc[l] : -1;
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
  auto finish = [&](int p, const float* f, float rem) {
    const size_t idx = g * pk + p;
    const int o = off[p], cnt = off[p + 1] - o;
    int k = cnt;
    if (CAPPED) {
      k = 0;
      while (k < cnt && (float)k < rem) ++k;
    }
    float acc[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
    for (int r = 0; r < k; ++r) {
      const int ln = sorted[o + r];
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        if (ch < c) acc[ch] += sdat[ch * s + ln];
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      if (ch < c) out[ch * npix + idx] = f[ch] + acc[ch];
  };
#pragma unroll
  for (int q = 0; q < PRE; ++q) {
    const int p = tid + q * THREADS;
    if (p < pk) finish(p, pre[q], pre_rem[q]);
  }
  for (int p = tid + PRE * THREADS; p < pk; p += THREADS) {
    float f[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      if (ch < c) f[ch] = film[ch * npix + g * pk + p];
    finish(p, f, CAPPED ? remaining[g * pk + p] : 0.0f);
  }
}

}  // namespace ss
