// Capacity-boundary bucket assignment (core/initial.py:
// initial_partition_device):
//
//     bin[v] = min(#{ i < k-1 : cum[v] >= boundary[i] }, k-1)
//
// Replaces the Pallas kernel repro/kernels/bucket_assign.py:
// bucket_assign_tiled. The k-1 boundaries are read once per block into
// shared memory; every thread then counts its vertex's crossings with the
// same >= comparison loop as the TPU kernel, so the count is exact for any
// boundary order (no binary search, which would need sorted boundaries).
// Traffic is 8 B per vertex plus the boundary row per block; the k-1
// compares per vertex come from shared memory (broadcast, no bank
// conflicts), so at the partitioner's sizes (n ~ 1e4, k <= 512) the kernel
// is bound by launch latency rather than by bytes or operations. The
// wrapper's clip to [0, k-1] is fused into the final store.
// prefix_split_kernel (below) is the whole capacity-prefix split of
// initial_partition_device in one launch: the inclusive scan of the node
// weights, the midpoints, the count against the boundaries and the clip.
// bucket_assign_kernel stays as the twin of the TPU kernel; no path runs it.
#include <math.h>

#include <cstdint>

#include "common.cuh"

__global__ void bucket_assign_kernel(const float* __restrict__ cum,
                                     const float* __restrict__ bounds,
                                     int* __restrict__ out, long long n,
                                     int n_bounds, int k) {
  extern __shared__ float s_bounds[];
  for (int i = threadIdx.x; i < n_bounds; i += blockDim.x)
    s_bounds[i] = bounds[i];
  __syncthreads();
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < n; v += stride) {
    float c = cum[v];
    int count = 0;
    for (int i = 0; i < n_bounds; ++i) count += (c >= s_bounds[i]) ? 1 : 0;
    out[v] = count < k - 1 ? count : k - 1;
  }
}

// The launch of kernels/bucket_assign.py's plan: a 1-d grid-stride grid,
// the boundaries in dynamic shared memory (at least nb floats).
REPRO_EXPORT int bucket_assign_launch(const void* cum, const void* bounds,
                                      void* out, long long n, int n_bounds,
                                      int k, REPRO_LAUNCH_PARAMS) {
  ReproLaunch L;
  if (!repro_launch_dims(gx, gy, gz, bx, by, bz, smem_bytes, 1024, &L) ||
      gy != 1 || gz != 1 || by != 1 || bz != 1 ||
      smem_bytes < static_cast<long long>(n_bounds) * sizeof(float))
    return REPRO_BAD_LAUNCH;
  bucket_assign_kernel<<<L.grid, L.block, L.smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cum), static_cast<const float*>(bounds),
      static_cast<int*>(out), n, n_bounds, k);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// prefix_split: the capacity-prefix split in one launch
//
//     cum[v] = (w[0] + ... + w[v]) - 0.5 * w[v]
//     bin[v] = min(#{ i < nb : boundary[i] <= cum[v] }, k - 1)
//
// over float32 node weights w [n] and nb non-decreasing float32 boundaries
// (the wrapper checks their order on the host; for sorted boundaries the
// binary search below counts exactly what bucket_assign's crossing loop
// counts, NaN midpoints included: no boundary is <= NaN). Each thread holds
// kSplitItems consecutive weights in registers; a tile is one block's
// threads x kSplitItems consecutive vertices. The scan: each thread's
// weights summed in order, the thread sums scanned across each warp by
// shuffles and across the warps through shared memory, then each thread
// walks its weights again from its exclusive prefix. Every sum is taken in
// an order fixed by n alone, so two calls give bitwise the same bins; for
// integer weights whose total is below 2^24 every sum is exact, and the
// bins equal those of any other scan order.
//
// n up to one tile (16,384 vertices at 1,024 threads) runs as one block.
// Beyond that, one cooperative launch: every block scans its tiles and
// writes each tile's total, one grid barrier, then each block sums the
// earlier tiles' totals in a fixed order (lane l of warp 0 those at l,
// l + 32, ..., then a shuffle tree) and scans its tiles from that offset.
// A block that owns one tile keeps its weights and prefixes in registers
// across the barrier; one owning more (n beyond the resident blocks'
// tiles) reads its tiles again. No decoupled look-back: its order of
// summation would depend on timing.
//
// Each block stages its tile's bins in shared memory (16 a thread, as
// 16-byte chunks placed by split_chunk) and then writes them out chunk by
// chunk across its threads, so a warp's store covers 512 consecutive
// bytes. Each thread writing its own 64 consecutive bytes directly left
// every store instruction half a sector a lane: 1.8 us more of kernel
// time in a trace (7.1 against 5.3) at the full cell's coarsest shape and
// 4.9 us more a call (19.0 against 14.1) at 1M vertices (PERF.md, section
// 6).
//
// Bound: 8 B a vertex (its weight in, its bin out) and the boundaries.
constexpr int kSplitThreads = 1024;
constexpr int kSplitItems = 16;

static __device__ __forceinline__ void split_grid_barrier(unsigned* count,
                                                          unsigned* gen) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* vgen = gen;
    const unsigned g = *vgen;
    __threadfence();
    if (atomicAdd(count, 1u) == gridDim.x - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd(gen, 1u);
    } else {
      while (*vgen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The weights of this thread's kSplitItems vertices of the tile at `base`
// (0 past n): four 16-byte loads where the run is whole and aligned.
static __device__ __forceinline__ void split_load(const float* __restrict__ w,
                                                  long long n, long long i0,
                                                  bool vec, float* v) {
  if (vec && i0 + kSplitItems <= n) {
    const float4* p = reinterpret_cast<const float4*>(w + i0);
#pragma unroll
    for (int q = 0; q < kSplitItems / 4; ++q) {
      const float4 t = __ldg(p + q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSplitItems; ++j)
      v[j] = i0 + j < n ? __ldg(w + i0 + j) : 0.0f;
  }
}

// The exclusive prefix of the threads' sums x in thread order, and the
// block's total, both to every thread. s_warp: 32 floats of shared memory.
static __device__ __forceinline__ void split_block_scan(float x,
                                                        float* s_warp,
                                                        float* excl,
                                                        float* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, y);
  }
  float ex = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) ex = 0.0f;
  if (lane == 31) s_warp[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    float t = lane < n_warps ? s_warp[lane] : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t = __fadd_rn(t, y);
    }
    s_warp[lane] = t;
  }
  __syncthreads();
  *excl = wid > 0 ? __fadd_rn(s_warp[wid - 1], ex) : ex;
  *total = s_warp[n_warps - 1];
  __syncthreads();
}

// One tile's scan: the thread's sum of its weights in order, then the
// block scan of those sums.
static __device__ __forceinline__ void split_tile_scan(const float* v,
                                                       float* s_warp,
                                                       float* excl,
                                                       float* total) {
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kSplitItems; ++j) sum = __fadd_rn(sum, v[j]);
  split_block_scan(sum, s_warp, excl, total);
}

// Where chunk q (4 bins) of thread t's 16 bins sits in the block's shared
// staging of the tile's bins: 16-byte chunks in tile order, but for the
// XOR, which spreads each quarter-warp's int4 stores (64 bytes apart) over
// all eight 16-byte bank groups, and keeps each group of 8 consecutive
// chunks (what a quarter-warp reads back) within one 128-byte row.
static __device__ __forceinline__ int split_chunk(int t, int q) {
  return (t << 2) | (q ^ ((t >> 1) & 3));
}

// The bins of this thread's vertices from its prefix `run` (the offset of
// the tile plus the thread's exclusive prefix): the midpoints, the count
// of boundaries at or below each, the clip, staged in s_bins. The count
// `at` of the previous vertex is kept where s_b[at - 1] <= c < s_b[at]
// (for sorted boundaries it is then the count of c too; a NaN c fails the
// first test and is searched, to 0); else a binary search over s_b finds
// it. The two boundaries around `at` stay in registers (-inf and +inf past
// the ends), so a vertex in its predecessor's bin reads no shared memory.
static __device__ __forceinline__ void split_emit(const float* v, float run,
                                                  const float* s_b, int nb,
                                                  int k, int4* s_bins) {
  int at = 0;
  float b_lo = -INFINITY, b_hi = nb > 0 ? s_b[0] : INFINITY;
#pragma unroll
  for (int q = 0; q < kSplitItems / 4; ++q) {
    int bin[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * q + u;
      run = __fadd_rn(run, v[j]);
      const float c = __fsub_rn(run, __fmul_rn(0.5f, v[j]));
      if (b_hi <= c || !(b_lo <= c)) {
        int lo = 0, hi = nb;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_b[mid] <= c) lo = mid + 1;
          else hi = mid;
        }
        at = lo;
        b_lo = at > 0 ? s_b[at - 1] : -INFINITY;
        b_hi = at < nb ? s_b[at] : INFINITY;
      }
      bin[u] = at < k - 1 ? at : k - 1;
    }
    s_bins[split_chunk(threadIdx.x, q)] =
        make_int4(bin[0], bin[1], bin[2], bin[3]);
  }
}

// The staged bins of the tile at `base` to `out`, after a barrier: thread
// i writes 16-byte chunks i, i + blockDim.x, ..., so a warp writes 512
// consecutive bytes an instruction (where out is 16-byte aligned and the
// chunk lies within n; else element by element).
static __device__ __forceinline__ void split_store(const int4* s_bins,
                                                   int* __restrict__ out,
                                                   long long base,
                                                   long long n, bool vec) {
  __syncthreads();
  const int chunks = blockDim.x * (kSplitItems / 4);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const long long g = base + 4LL * c;
    if (g >= n) break;
    const int4 b = s_bins[split_chunk(c >> 2, c & 3)];
    if (vec && g + 4 <= n) {
      *reinterpret_cast<int4*>(out + g) = b;
    } else {
      const int e[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (g + u < n) out[g + u] = e[u];
    }
  }
}

// kCoop: the cooperative launch (tile_tot [tiles] and bar, two barrier
// words, in the wrapper's workspace); else one block, one tile.
template <bool kCoop>
__global__ void __launch_bounds__(kSplitThreads)
prefix_split_kernel(const float* __restrict__ w,
                    const float* __restrict__ bounds, int* __restrict__ out,
                    float* tile_tot, unsigned* bar, long long n, int nb,
                    int k, int vec) {
  // dynamic shared memory: the tile's bins (16-byte chunks), then the
  // boundaries
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ float s_warp[32];
  __shared__ float s_off;
  const long long tile = static_cast<long long>(blockDim.x) * kSplitItems;
  int4* s_bins = reinterpret_cast<int4*>(s_dyn);
  float* s_b = reinterpret_cast<float*>(s_dyn + tile * sizeof(int));
  const long long n_tiles = (n + tile - 1) / tile;
  const long long lead = static_cast<long long>(threadIdx.x) * kSplitItems;
  // the first tile's weights in flight while the boundaries are staged
  float v[kSplitItems];
  if (blockIdx.x < n_tiles) split_load(w, n, blockIdx.x * tile + lead, vec, v);
  for (int i = threadIdx.x; i < nb; i += blockDim.x) s_b[i] = bounds[i];
  float excl = 0.0f, total = 0.0f;
  if (kCoop) {
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      if (t != blockIdx.x) split_load(w, n, t * tile + lead, vec, v);
      split_tile_scan(v, s_warp, &excl, &total);
      if (threadIdx.x == 0) tile_tot[t] = total;
    }
    split_grid_barrier(bar, bar + 1);
  }
  const bool kept = kCoop && n_tiles == gridDim.x;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    float off = 0.0f;
    if (kCoop) {
      if (threadIdx.x < 32) {
        float p = 0.0f;
        for (long long i = threadIdx.x; i < t; i += 32)
          p = __fadd_rn(p, __ldcg(tile_tot + i));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          p = __fadd_rn(p, __shfl_down_sync(0xffffffffu, p, o));
        if (threadIdx.x == 0) s_off = p;
      }
      __syncthreads();
      off = s_off;
    }
    if (!kept) {
      // after phase 1 (kCoop) v holds the block's last tile
      if (kCoop || t != blockIdx.x)
        split_load(w, n, t * tile + lead, vec, v);
      split_tile_scan(v, s_warp, &excl, &total);   // also orders s_b
    }
    split_emit(v, __fadd_rn(off, excl), s_b, nb, k, s_bins);
    split_store(s_bins, out, t * tile, n, vec != 0);
    __syncthreads();      // s_bins and s_off are rewritten for the next tile
  }
}

// The launch of kernels/bucket_assign.py's split plan. coop = 0: one block
// of bx threads over n <= bx * kSplitItems vertices; coop = 1: one
// cooperative launch of gx blocks (a grid the card cannot hold at once is
// refused by the launch, never cut). Either way the dynamic shared memory
// is the tile's bins and the boundaries, bx * kSplitItems * 4 + max(nb, 1)
// * 4 bytes (refused if the plan's differs). `work`: two barrier words,
// zero before the first call (every call leaves them ready), then room for
// one float per tile; unused by the one-block path.
REPRO_EXPORT int prefix_split_launch(const void* w, const void* bounds,
                                     void* out, void* work, long long n,
                                     int nb, int k, int coop,
                                     REPRO_LAUNCH_PARAMS) {
  ReproLaunch L;
  const long long want = static_cast<long long>(bx) * kSplitItems * 4 +
                         static_cast<long long>(nb > 0 ? nb : 1) * 4;
  if (!repro_launch_dims(gx, gy, gz, bx, by, bz, smem_bytes, kSplitThreads,
                         &L) ||
      gy != 1 || gz != 1 || by != 1 || bz != 1 || bx % 32 != 0 ||
      smem_bytes != want ||
      (!coop && (gx != 1 || n > static_cast<long long>(bx) * kSplitItems)))
    return REPRO_BAD_LAUNCH;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int vec = (reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(out) % 16 == 0) ? 1 : 0;
  const float* p_w = static_cast<const float*>(w);
  const float* p_b = static_cast<const float*>(bounds);
  int* p_out = static_cast<int*>(out);
  unsigned* p_bar = static_cast<unsigned*>(work);
  float* p_tot = static_cast<float*>(work) + 2;
  if (!coop) {
    cudaError_t e = repro_smem_optin(prefix_split_kernel<false>, L.smem);
    if (e != cudaSuccess) return repro_fail(e);
    prefix_split_kernel<false><<<L.grid, L.block, L.smem, s>>>(
        p_w, p_b, p_out, p_tot, p_bar, n, nb, k, vec);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t e = repro_smem_optin(prefix_split_kernel<true>, L.smem);
  if (e != cudaSuccess) return repro_fail(e);
  void* args[] = {&p_w, &p_b, &p_out, &p_tot, &p_bar, &n, &nb, &k, &vec};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(prefix_split_kernel<true>), L.grid, L.block,
      args, L.smem, s);
  if (e != cudaSuccess) return repro_fail(e);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT const void* bucket_assign_kernel_of(const char* name) {
  return std::strcmp(name, "bucket_assign_kernel") == 0
             ? reinterpret_cast<const void*>(bucket_assign_kernel)
             : nullptr;
}

REPRO_EXPORT const void* prefix_split_kernel_of(const char* name) {
  if (std::strcmp(name, "prefix_split_kernel<true>") == 0)
    return reinterpret_cast<const void*>(prefix_split_kernel<true>);
  if (std::strcmp(name, "prefix_split_kernel<false>") == 0)
    return reinterpret_cast<const void*>(prefix_split_kernel<false>);
  return nullptr;
}
