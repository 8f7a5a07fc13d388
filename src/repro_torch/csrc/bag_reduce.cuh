// The weighted bag reduction shared by bag_combine.cu and gather_combine.cu:
//
//     out[b, f] = sum over slots d of w[b, d] * row(b, d)[f]
//
// where row(b, d) is table[idx[b, d]] (gather_combine: the gather fused) or
// g[b, d] (bag_combine: rows gathered beforehand). Both are streaming
// reductions of ~0.5 flop per byte, bound by device-memory bytes.
//
// One block row (threadIdx.y) per bag, threads across F in 16-byte float4
// loads where F % 4 == 0 (else one float each), so a warp reads 512
// consecutive bytes of a row. The block first stages a chunk of its bags'
// ids and weights in shared memory (coalesced), then each thread walks the
// chunk's slots in order and accumulates in registers. A grid too small to
// fill the card (serve_p99: 512 bags of F = 256 are 32k threads) is set by
// how many rounds of device-memory latency each thread waits through, so
// there the rows of kBagDepth slots are loaded into registers before any
// of them is summed (1 + ceil(D / kBagDepth) rounds). That costs registers
// and so resident threads, which a grid that fills the card needs more
// (serve_bulk's gather): there each slot's row is loaded and summed in
// turn, the loop unrolled 8 times. Every product and sum is rounded on its
// own (__fmul_rn, __fadd_rn: nvcc cannot contract them into an FMA) and
// the slots are added in order starting from 0 on either path, so both
// kernels give bitwise the same result for the same rows and weights, and
// the result matches the TPU kernels' mul-then-add. Slots of weight 0 are
// read like any other. A bf16 table (gather_combine) or bf16 rows with
// bf16 weights (bag_combine) are widened to float as they are read, summed
// in float32 the same way, and the sum is rounded once to bf16 as it is
// stored.
//
// A grid that cannot fill the card (fewer blocks than the multiprocessors
// the wrapper passes; one retrieve query is one bag) takes a third path that
// spreads F over more blocks: one warp per block over 32 float columns of
// one bag, so one bag of F = 256 runs on 8 multiprocessors instead of one.
// The warp reads a chunk's weights (and ids) in one coalesced load per 32
// slots and hands each slot's value to every lane by a shuffle, with no
// shared-memory staging and no __syncthreads, and each thread issues all
// of a chunk's rows (64; 16 where D <= 16) before its first add: a call waits
// through one device-memory latency per chunk (two for the gather, whose
// row addresses come from the ids), not one per kBagDepth rows. The slots
// are summed in the same order with the same rounding.
#pragma once

#include <cuda_bf16.h>

#include <algorithm>

#include "common.cuh"

constexpr int kBagChunk = 64;    // slots staged per pass
constexpr int kBagMaxRows = 8;   // bags per block at most
constexpr int kBagDepth = 16;    // rows loaded ahead of the sum per thread
// grids of at most this many threads load kBagDepth rows ahead
constexpr long long kBagDeepMaxThreads = 1 << 16;
// slots in flight per thread on the small-grid path: kBagSmallChunk, or
// kBagSmallShort where d is at most that (a shorter add chain)
constexpr int kBagSmallChunk = 64;
constexpr int kBagSmallShort = 16;

__device__ __forceinline__ float bag_zero(float*) { return 0.0f; }
__device__ __forceinline__ float4 bag_zero(float4*) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// a slot's weight as it is summed: float32 as stored, bf16 widened
__device__ __forceinline__ float bag_weight(float w) { return w; }
__device__ __forceinline__ float bag_weight(__nv_bfloat16 w) {
  return __bfloat162float(w);
}

__device__ __forceinline__ float bag_acc(float acc, float w, float t) {
  return __fadd_rn(acc, __fmul_rn(w, t));
}
__device__ __forceinline__ float4 bag_acc(float4 acc, float w, float4 t) {
  acc.x = bag_acc(acc.x, w, t.x);
  acc.y = bag_acc(acc.y, w, t.y);
  acc.z = bag_acc(acc.z, w, t.z);
  acc.w = bag_acc(acc.w, w, t.w);
  return acc;
}

// The stored column type V of a row (float4, float, eight bf16 or one) and
// its float accumulator: a loaded column is widened to float where it is
// added (so the rows in flight keep their stored size in registers), and
// the store rounds once.
template <typename V> struct BagCol;
template <> struct BagCol<float4> {
  using Acc = float4;
  static __device__ __forceinline__ float4 widen(float4 a) { return a; }
  static __device__ __forceinline__ void store(float4* p, float4 a) {
    *p = a;
  }
};
template <> struct BagCol<float> {
  using Acc = float;
  static __device__ __forceinline__ float widen(float a) { return a; }
  static __device__ __forceinline__ float ldg(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, float a) { *p = a; }
};
// eight bf16 columns (16 bytes) and their float accumulators
struct __align__(16) Bf16x8 {
  __nv_bfloat162 h[4];
};
struct Float8 {
  float v[8];
};
__device__ __forceinline__ Float8 bag_zero(Float8*) {
  Float8 a;
#pragma unroll
  for (int i = 0; i < 8; ++i) a.v[i] = 0.0f;
  return a;
}
__device__ __forceinline__ Float8 bag_acc(Float8 acc, float w, Float8 t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) acc.v[i] = bag_acc(acc.v[i], w, t.v[i]);
  return acc;
}
template <> struct BagCol<Bf16x8> {
  using Acc = Float8;
  static __device__ __forceinline__ Float8 widen(Bf16x8 q) {
    Float8 a;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(q.h[i]);
      a.v[2 * i] = t.x;
      a.v[2 * i + 1] = t.y;
    }
    return a;
  }
  static __device__ __forceinline__ void store(Bf16x8* p, Float8 a) {
    Bf16x8 q;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q.h[i] = __floats2bfloat162_rn(a.v[2 * i], a.v[2 * i + 1]);
    *p = q;
  }
};
template <> struct BagCol<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ float widen(__nv_bfloat16 h) {
    return __bfloat162float(h);
  }
  static __device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float a) {
    *p = __float2bfloat16_rn(a);
  }
};

// V is float4 or float (a float32 table) or Bf16x8 or __nv_bfloat16 (a
// bf16 table); cols = F / (elements of V) columns of V per row; kDepth rows
// are loaded before they are summed (kBagDepth or 1); W, the weights'
// type, float or __nv_bfloat16.
template <typename V, bool kGather, int kDepth, typename W>
__global__ void bag_reduce_kernel(const void* __restrict__ src,
                                  const int* __restrict__ idx,
                                  const W* __restrict__ w,
                                  void* __restrict__ out, long long n_bags,
                                  int d, int cols) {
  using Acc = typename BagCol<V>::Acc;
  __shared__ int s_idx[kBagMaxRows][kBagChunk];
  __shared__ float s_w[kBagMaxRows][kBagChunk];
  const int by = threadIdx.y;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.y + by;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = b < n_bags;
  const bool active = live && col < cols;
  const V* rows = reinterpret_cast<const V*>(src);
  Acc acc = bag_zero(static_cast<Acc*>(nullptr));
  for (int d0 = 0; d0 < d; d0 += kBagChunk) {
    const int nd = min(kBagChunk, d - d0);
    if (live) {
      for (int j = threadIdx.x; j < nd; j += blockDim.x) {
        const long long slot = b * d + d0 + j;
        s_w[by][j] = bag_weight(w[slot]);
        if (kGather) s_idx[by][j] = idx[slot];
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll (kDepth == 1 ? 8 : 1)
      for (int j0 = 0; j0 < nd; j0 += kDepth) {
        V t[kDepth];
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          const int j = j0 + u;
          if (j < nd) {
            const long long row = kGather ? static_cast<long long>(s_idx[by][j])
                                          : b * d + d0 + j;
            t[u] = rows[row * cols + col];
          }
        }
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          if (j0 + u < nd)
            acc = bag_acc(acc, s_w[by][j0 + u], BagCol<V>::widen(t[u]));
        }
      }
    }
    __syncthreads();
  }
  if (active)
    BagCol<V>::store(reinterpret_cast<V*>(out) + b * cols + col, acc);
}

// The small-grid path: block (32), grid (ceil(f / 32), n_bags); kChunk
// slots in flight per thread; E is the element type (float or bf16), W
// the weights' type.
template <typename E, bool kGather, int kChunk, typename W>
__global__ void __launch_bounds__(32)
bag_reduce_small_kernel(const E* __restrict__ src,
                        const int* __restrict__ idx,
                        const W* __restrict__ w, E* __restrict__ out,
                        int d, int f) {
  const long long b = blockIdx.y;
  const int lane = threadIdx.x;
  const int col = blockIdx.x * 32 + lane;
  const bool active = col < f;
  const int col_in = min(col, f - 1);
  constexpr int kH = (kChunk + 31) / 32;
  float acc = 0.0f;
  for (int d0 = 0; d0 < d; d0 += kChunk) {
    const int nd = min(kChunk, d - d0);
    const long long slot0 = b * d + d0;
    // the chunk's weights (and ids): one coalesced load per 32 slots, each
    // slot's value then broadcast to the warp by a shuffle
    float wl[kH];
    int il[kH];
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const int u = min(h * 32 + lane, nd - 1);
      wl[h] = bag_weight(__ldg(w + slot0 + u));
      il[h] = kGather ? __ldg(idx + slot0 + u) : 0;
    }
    // every row of the chunk in flight before the first add, with no
    // branch between the loads: slots past nd read slot nd - 1's row again
    // and are not added
    float t[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int uc = min(u, nd - 1);
      int held = il[0];                   // the register holding slot uc
#pragma unroll
      for (int h = 1; h < kH; ++h) held = uc >= h * 32 ? il[h] : held;
      const long long row =
          kGather ? __shfl_sync(0xffffffffu, held, uc & 31) : slot0 + uc;
      t[u] = BagCol<E>::ldg(src + row * f + col_in);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float wu = __shfl_sync(0xffffffffu, wl[u / 32], u % 32);
      const float next = bag_acc(acc, wu, t[u]);
      acc = u < nd ? next : acc;
    }
  }
  if (active) BagCol<E>::store(out + b * f + col, acc);
}

template <typename V, bool kGather, typename W>
static void bag_reduce_run(dim3 grid, dim3 block, cudaStream_t s, bool deep,
                           const void* src, const int* idx, const W* w,
                           void* out, long long n_bags, int d, int cols) {
  if (deep) {
    bag_reduce_kernel<V, kGather, kBagDepth, W><<<grid, block, 0, s>>>(
        src, idx, w, out, n_bags, d, cols);
  } else {
    bag_reduce_kernel<V, kGather, 1, W><<<grid, block, 0, s>>>(
        src, idx, w, out, n_bags, d, cols);
  }
}

// The usual path's launch shape for n_bags bags of cols columns of V:
// 128 threads a block, one block row per bag.
struct BagGeometry {
  dim3 block, grid;
};

static BagGeometry bag_geometry(long long n_bags, int cols) {
  const int tx = std::min((cols + 31) / 32 * 32, 256);
  const int ty = std::max(1, std::min(kBagMaxRows, 128 / tx));
  return {dim3(tx, ty), dim3(static_cast<unsigned>((n_bags + ty - 1) / ty),
                             (cols + tx - 1) / tx)};
}

// Whether a launch takes the small-grid path: the usual grid has fewer
// blocks than the card's sms multiprocessors, and the bags fit the small
// grid's second axis.
static bool bag_small_grid(long long n_bags, int f, int vec, int sms) {
  const dim3 g = bag_geometry(n_bags, f / vec).grid;
  return static_cast<long long>(g.x) * g.y < sms && n_bags <= 65535;
}

// The vec the small-grid rule reads: the launch's own for float32, float4
// columns (where f % 4 == 0) for bf16.
template <typename E>
static int bag_rule_vec(int f, int vec) {
  if constexpr (sizeof(E) == 2) return f % 4 == 0 ? 4 : 1;
  return vec;
}

// The small-grid path, for E = float or __nv_bfloat16.
template <typename E, bool kGather, typename W>
static void bag_reduce_small_run(cudaStream_t s, const void* src,
                                 const int* idx, const W* w, void* out,
                                 long long n_bags, int d, int f) {
  const dim3 grid((f + 31) / 32, static_cast<unsigned>(n_bags));
  const E* src_e = static_cast<const E*>(src);
  E* out_e = static_cast<E*>(out);
  if (d <= kBagSmallShort)
    bag_reduce_small_kernel<E, kGather, kBagSmallShort, W>
        <<<grid, 32, 0, s>>>(src_e, idx, w, out_e, d, f);
  else
    bag_reduce_small_kernel<E, kGather, kBagSmallChunk, W>
        <<<grid, 32, 0, s>>>(src_e, idx, w, out_e, d, f);
}

// Launch over n_bags bags of d slots and f elements on a card of sms
// multiprocessors. E = float: vec is 4 (float4 rows, f % 4 == 0 and
// 16-byte aligned pointers, checked by the wrapper) or 1; E =
// __nv_bfloat16: vec is 8 (16-byte rows of eight, likewise) or 1. The
// small-grid rule reads the grid of float4 columns (vec 4 where f % 4 ==
// 0) for either type, so a bf16 call takes the path a float32 one of the
// same shape takes. W, the weights' type: float, or __nv_bfloat16 with a
// bf16 E (bag_combine's bf16 rows), widened as they are read.
template <bool kGather, typename E = float, typename W = float>
static int bag_reduce_launch(const void* src, const void* idx, const void* w,
                             void* out, long long n_bags, int d, int f,
                             int vec, int sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx_i = static_cast<const int*>(idx);
  const W* w_f = static_cast<const W*>(w);
  if (bag_small_grid(n_bags, f, bag_rule_vec<E>(f, vec), sms)) {
    bag_reduce_small_run<E, kGather>(s, src, idx_i, w_f, out, n_bags, d, f);
    return static_cast<int>(cudaGetLastError());
  }
  const int cols = f / vec;
  const BagGeometry geo = bag_geometry(n_bags, cols);
  const bool deep = n_bags * cols <= kBagDeepMaxThreads;
  if constexpr (sizeof(E) == 2) {
    if (vec == 8)
      bag_reduce_run<Bf16x8, kGather>(geo.grid, geo.block, s, deep, src,
                                      idx_i, w_f, out, n_bags, d, cols);
    else
      bag_reduce_run<__nv_bfloat16, kGather>(geo.grid, geo.block, s, deep,
                                             src, idx_i, w_f, out, n_bags, d,
                                             cols);
  } else if (vec == 4) {
    bag_reduce_run<float4, kGather>(geo.grid, geo.block, s, deep, src, idx_i,
                                    w_f, out, n_bags, d, cols);
  } else {
    bag_reduce_run<float, kGather>(geo.grid, geo.block, s, deep, src, idx_i,
                                   w_f, out, n_bags, d, cols);
  }
  return static_cast<int>(cudaGetLastError());
}
