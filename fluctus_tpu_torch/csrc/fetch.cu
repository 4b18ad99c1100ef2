// K8 — per-lane read of a padded per-pixel table (the exact-spp path's
// per-path spp lookup).
//
// Replaces: fluctus_tpu/core/block_splat.py, _fetch_kernel (called by
// fetch).
//
//   out[i] = table[(i / s) * pk + local[i]]   for 0 <= local[i] < pk,
//            0 otherwise (the TPU kernel's compare-select gives 0 there)
// for the G groups of s lanes and pk padded pixels per group.
//
// Bound on the H100: memory. 4 B of local and 4 B of output per lane, plus
// the table entries the lanes read; at 1080p with 1M paths, under 13 MB,
// about 4 us at 3.35 TB/s. The TPU kernel built a [S, Pk] one-hot per
// group and reduced it, because Mosaic has no per-lane gather; Hopper has
// one.
//
// Design: bytes in flight. One thread per lane has one 4-byte request in
// flight at a time, its gather waiting on its local load. Here
// a thread takes LANES_PER_THREAD consecutive lanes, a "chunk": one 16-byte
// streaming load of local per 4 lanes, the chunk's table reads issued back
// to back through the read-only path before any is used, one 16-byte
// streaming store per 4 lanes. s is a multiple of the lanes per thread, so
// a chunk lies in one group: its group is chunk / (s / LANES_PER_THREAD),
// one divide per chunk. The grid is one wave of resident CTAs (the
// occupancy API's count per SM, times the SMs) striding over the chunks;
// each thread issues its next chunk's local load before its current
// gathers. Shapes whose s is not a multiple of the lanes per thread, and
// pointers not aligned to a chunk, take the scalar loop of the same kernel
// (a divide per lane).
#include "common.cuh"

constexpr int LANES_PER_THREAD = 4;
constexpr int THREADS = 256;
constexpr int V = LANES_PER_THREAD;
static_assert(V == 1 || V == 2 || V % 4 == 0, "1, 2 or a multiple of 4");

// The chunk's locals: read once, so streamed past L1/L2's keep lines.
__device__ __forceinline__ void load_chunk(const int* __restrict__ p,
                                           int (&l)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(p + k));
      l[k] = q.x;
      l[k + 1] = q.y;
      l[k + 2] = q.z;
      l[k + 3] = q.w;
    }
  } else if constexpr (V == 2) {
    const int2 q = __ldcs(reinterpret_cast<const int2*>(p));
    l[0] = q.x;
    l[1] = q.y;
  } else {
    l[0] = __ldcs(p);
  }
}

__device__ __forceinline__ void store_chunk(float* __restrict__ p,
                                            const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      __stcs(reinterpret_cast<float4*>(p + k),
             make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcs(p, v[0]);
  }
}

// vec: s % V == 0 and local, out aligned to a chunk (the launcher's test,
// uniform over the grid). nchunks = n / V, cpg = s / V chunks per group.
__global__ void __launch_bounds__(THREADS)
fetch_kernel(const int* __restrict__ local, const float* __restrict__ table,
             float* __restrict__ out, int n, int s, int pk, int vec) {
  const int stride = gridDim.x * blockDim.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (!vec) {
    for (int i = t; i < n; i += stride) {
      const int l = local[i];
      out[i] = ((unsigned)l < (unsigned)pk)
                   ? __ldg(table + (size_t)(i / s) * pk + l)
                   : 0.0f;
    }
    return;
  }
  const int nchunks = n / V;
  const unsigned cpg = (unsigned)(s / V);
  int c = t;
  if (c >= nchunks) return;
  int l[V];
  load_chunk(local + (size_t)c * V, l);
  while (true) {
    const int next = c + stride;
    int ln[V];
    if (next < nchunks) load_chunk(local + (size_t)next * V, ln);
    const float* row = table + (size_t)((unsigned)c / cpg) * pk;
    float v[V];
#pragma unroll
    for (int k = 0; k < V; ++k)
      v[k] = ((unsigned)l[k] < (unsigned)pk) ? __ldg(row + l[k]) : 0.0f;
    store_chunk(out + (size_t)c * V, v);
    if (next >= nchunks) break;
    c = next;
#pragma unroll
    for (int k = 0; k < V; ++k) l[k] = ln[k];
  }
}

// Resident CTAs of fetch_kernel per SM and the SM count, per device.
static int grid_cap(int dev) {
  static int cap[64];
  if (dev < 0 || dev >= 64) return 0;
  if (cap[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fetch_kernel,
                                                      THREADS, 0) ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      return 0;
    cap[dev] = per_sm * sms;
  }
  return cap[dev];
}

extern "C" int fetch_launch(const int* local, const float* table, float* out,
                            int n, int s, int pk, void* stream) {
  if (n == 0) return 0;
  const size_t chunk_bytes = sizeof(int) * V;
  const int vec = (s % V == 0) &&
                  (reinterpret_cast<uintptr_t>(local) % chunk_bytes == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % chunk_bytes == 0);
  const int work = vec ? n / V : n;
  int dev = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e) return e;
  const int cap = grid_cap(dev);
  if (cap == 0) {
    e = (int)cudaGetLastError();
    return e ? e : (int)cudaErrorUnknown;
  }
  const int want = (work + THREADS - 1) / THREADS;
  fetch_kernel<<<want < cap ? want : cap, THREADS, 0,
                 (cudaStream_t)stream>>>(local, table, out, n, s, pk, vec);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING
