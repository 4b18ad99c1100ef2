// K2 — rays-on-lanes cluster trace, closest-hit and any-hit.
//
// Replaces: fluctus_tpu/accel/mxu_trace.py, _trace_kernel_rol (called by
// _trace_rol).
//
// One tile of rt rays walks its sorted candidate-cluster list (K1 + sort).
// Per candidate slot: a per-ray slab cull; if any ray of the tile enters
// the box (and the slot is a real cluster) every ray sweeps the cluster's
// tc triangles through their affine unit-triangle transforms:
//   t = -oz/dz, u = ox + t*dx, v = oy + t*dy,
//   valid = dz != 0 & t > 0 & min(u, v, 1-u-v) >= 0.
// Closest-hit keeps the minimum packed int32 key (bits(t) & ~(tc-1)) | row
// (invalid -> 0x7F800000) and updates on a strict tmin < t_best, col =
// row + c*tc; the returned t is the quantized key value. Any-hit sets
// i = 1, t = 0 once a valid t < t_best exists. The tile stops when the next
// slot is the -1 sentinel, its entry bound exceeds the tile's largest
// t_best, or that largest t_best is <= 0. Rays are packed per tile [8, rt]
// (ox oy oz 1 dx dy dz 0), the transforms are t12 [12, m_pad].
//
// Bound on the H100: FP32 operations. ~30 operations per (ray, triangle)
// pair of every visited cluster: sum over tiles of visited_clusters * tc *
// rt * 30. The rays, the candidate lists and the transforms of a visited
// cluster (12 KB at tc = 256) are the only bytes read. Under -fmad=false no
// multiply-add fuses, so the attainable rate is about half that bound.
// Sorted tiles visit few clusters, unevenly (luxball, segment 4: median 1,
// p99 13, max 27 per tile, 2,745 in 2,048 tiles; the production cell's
// segment 16: median 1, p99 33, max 46, 8,751 closest-hit), so the time is
// the heaviest tiles' visits plus each tile's fixed cost (ray loads, the
// first vote, the stop tests).
//
// Design: K9's walk (sweep_hopper.cuh, walk_flat) on K2's layouts: up to 32
// candidates decided by one vote, the cluster staged by cp.async into
// 48-byte triangle records, the next possibly live cluster fetched into a
// second buffer while the current one is swept. Closest-hit: a tile is one
// CTA of 1,024 threads, 2 rays per thread in 4 ray groups, each group
// sweeping a quarter of every visited cluster's triangles; any-hit: a
// cluster of 2 CTAs of 512 threads, one ray each, each CTA sweeping half of
// them, so a heavy tile's visits run on 2 SMs.
//
// The tiles meet the card heaviest first. tile_queue_kernel orders them by
// K1's live-candidate count (the slots of a list before its first -1),
// ties in tile index order, on the card; cluster b of the launch walks
// tile queue[b] and writes t, i and visits at that tile's own index. The
// block scheduler starts clusters in index order as SMs free, so a heavy
// tile starts early instead of running its serial visits almost alone at
// the end of the launch; tiles are independent, so the order changes no
// bit. The count ranks the tiles as their visits do (rank correlation
// 0.994 closest-hit, 0.830 any-hit on the production cell's rays). A
// persistent grid that took tiles from the same queue with an atomic
// counter was slower at every call measured (PERF.md).
#include "sweep_hopper.cuh"

// Shapes, Config<rays per thread, ray groups per CTA, CTAs per tile>, the
// least worst-case loss over the calls sweep_shapes.py times on an H100
// (luxball segments 4 and 24, the production cell's segment 16, megastep
// bounce 2; PERF.md): closest-hit, any-hit.
using Closest = hs::Config<2, 4, 1>;
using AnyHit = hs::Config<1, 1, 2>;

// The queue kernel's threads (one CTA).
constexpr int QUEUE_THREADS = 1024;

// The queue: the tiles heaviest first by their live-candidate count, ties
// in index order (a stable descending counting sort in one CTA). K1's
// lists hold their -1s as a suffix (culled bounds sort last), so a tile's
// count is found by bisection. stats [2] adds the tiles queued and those
// queued out of index order. Shared memory: ncl_pad + 1 bases, then the nt
// counts.
__global__ void __launch_bounds__(QUEUE_THREADS)
    tile_queue_kernel(const int* __restrict__ order, int nt, int ncl_pad,
                      int* __restrict__ queue,
                      unsigned long long* __restrict__ stats) {
  extern __shared__ int qs[];
  int* base = qs;                  // [ncl_pad + 1]: histogram, then bases
  int* count = qs + ncl_pad + 1;   // [nt]
  const int tid = threadIdx.x;
  for (int v = tid; v <= ncl_pad; v += blockDim.x) base[v] = 0;
  __syncthreads();
  for (int k = tid; k < nt; k += blockDim.x) {
    const int* row = order + (size_t)k * ncl_pad;
    int lo = 0, hi = ncl_pad;      // the first -1 lies in [lo, hi]
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row[mid] < 0)
        hi = mid;
      else
        lo = mid + 1;
    }
    count[k] = lo;
    atomicAdd(&base[lo], 1);
  }
  __syncthreads();
  if (tid >= 32) return;
  // base[v] = the tiles with a larger count (a descending exclusive scan)
  int run = 0;
  for (int top = ncl_pad; top >= 0; top -= 32) {
    const int v = top - tid;
    const int x = v >= 0 ? base[v] : 0;
    int inc = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, inc, off);
      if (tid >= off) inc += y;
    }
    if (v >= 0) base[v] = run + inc - x;
    run += __shfl_sync(FULL_MASK, inc, 31);
  }
  __syncwarp();
  // the stable scatter, 32 tiles at a time in index order: a tile's place
  // is its count's base plus the earlier tiles of that count in its warp
  const unsigned below = (1u << tid) - 1u;
  int moved = 0;
  for (int k0 = 0; k0 < nt; k0 += 32) {
    const int k = k0 + tid;
    const int v = k < nt ? count[k] : -1;
    const unsigned peers = __match_any_sync(FULL_MASK, v);
    int at = 0;
    if (k < nt) at = base[v] + __popc(peers & below);
    __syncwarp();
    if (k < nt) {
      queue[at] = k;
      moved += at != k;
      if ((peers & below) == 0) base[v] += __popc(peers);
    }
    __syncwarp();
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    moved += __shfl_xor_sync(FULL_MASK, moved, off);
  if (tid == 0) {
    atomicAdd(&stats[0], (unsigned long long)nt);
    atomicAdd(&stats[1], (unsigned long long)moved);
  }
}

template <class C, bool ANY_HIT>
__global__ void __launch_bounds__(C::MAX_THREADS)
    trace_rol_kernel(const float* __restrict__ rays,
                     const float* __restrict__ tm,
                     const int* __restrict__ order,
                     const float* __restrict__ cons,
                     const float* __restrict__ t12,
                     const float* __restrict__ boxes,
                     const int* __restrict__ queue,
                     float* __restrict__ t_out, int* __restrict__ i_out,
                     int* __restrict__ visits, int rt, int ncl_pad,
                     int n_clusters, long long m_pad) {
  using Tile = hs::Tile<C, ANY_HIT>;
  __shared__ hs::Shared<C> sh;
  Tile T(sh, hs::Source{t12, t12 + 4 * m_pad, t12 + 8 * m_pad, m_pad});
  const size_t tile = queue[Tile::tile()];
#pragma unroll
  for (int r = 0; r < C::RAYS; ++r) {
    const int lane = T.lane(r);
    T.y[r] = load_ray(rays + tile * 8 * rt, rt, lane);
    T.t_best[r] = tm[tile * rt + lane];
    T.i_best[r] = -1;
  }
  hs::walk_flat(T, order + tile * ncl_pad, cons + tile * ncl_pad, boxes,
                n_clusters);
  if (T.writer()) {
#pragma unroll
    for (int r = 0; r < C::RAYS; ++r) {
      t_out[tile * rt + T.lane(r)] = T.t_best[r];
      i_out[tile * rt + T.lane(r)] = T.i_best[r];
    }
    if (threadIdx.x == 0) visits[tile] = T.n_live;
  }
  T.finish();
}

// The queue's launch for nt tiles of ncl_pad slots; invalid value when its
// counts do not fit in shared memory.
static int queue_launch(const int* order, int nt, int ncl_pad, int* queue,
                        long long* stats, cudaStream_t s) {
  const size_t smem = sizeof(int) * ((size_t)ncl_pad + 1 + (size_t)nt);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  static size_t raised = 48 * 1024;
  if (smem > raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile_queue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    raised = smem;
  }
  tile_queue_kernel<<<1, QUEUE_THREADS, smem, s>>>(
      order, nt, ncl_pad, queue, reinterpret_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}

// Two launches: the queue, then one cluster a tile in the queue's order.
// queue [nt] is the caller's int32 scratch; stats [2] int64 adds the tiles
// queued and those queued out of index order.
extern "C" int trace_rol_launch(const float* rays, const float* tm,
                                const int* order, const float* cons,
                                const float* t12, const float* boxes,
                                float* t_out, int* i_out, int* visits,
                                int* queue, long long* stats, int nt, int rt,
                                int ncl_pad, int n_clusters, int tc,
                                long long m_pad, int any_hit, void* stream) {
  if (nt == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int e = queue_launch(order, nt, ncl_pad, queue, stats, s);
  if (e) return e;
  if (any_hit)
    return hs::launch<AnyHit>(trace_rol_kernel<AnyHit, true>, nt, rt, tc, s,
                              rays, tm, order, cons, t12, boxes,
                              (const int*)queue, t_out, i_out, visits, rt,
                              ncl_pad, n_clusters, m_pad);
  return hs::launch<Closest>(trace_rol_kernel<Closest, false>, nt, rt, tc, s,
                             rays, tm, order, cons, t12, boxes,
                             (const int*)queue, t_out, i_out, visits, rt,
                             ncl_pad, n_clusters, m_pad);
}

// The queue kernel alone (chip_smoke.py holds it to tile_queue_plain).
extern "C" int tile_queue_launch(const int* order, int nt, int ncl_pad,
                                 int* queue, long long* stats,
                                 void* stream) {
  if (nt == 0) return 0;
  return queue_launch(order, nt, ncl_pad, queue, stats, (cudaStream_t)stream);
}

// Tiles in flight, CTAs per tile and threads per CTA (hs::occupancy).
extern "C" int trace_rol_occupancy(int any_hit, int rt, int* out) {
  return any_hit
             ? hs::occupancy<AnyHit>(trace_rol_kernel<AnyHit, true>, rt, out)
             : hs::occupancy<Closest>(trace_rol_kernel<Closest, false>, rt,
                                      out);
}

KERNEL_ERROR_STRING
