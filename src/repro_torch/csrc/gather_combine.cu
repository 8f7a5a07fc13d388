// Fused embedding-bag gather + combine (ShardedEmbeddingTable.lookup_bags):
//
//     out[b, f] = sum over slots d of w[b, d] * table[idx[b, d], f]
//
// Replaces the Pallas kernel repro/kernels/gather_combine.py:gather_combine,
// which scalar-prefetches the ids and DMAs one row tile per sequential grid
// step into a resident output block. Bound: the rows the bags name, each
// distinct row once (a Zipf stream repeats hot rows; padding slots name row
// 0), the ids and weights (8 bytes per slot) and the output. Ids must lie
// in [0, V): callers map padding to row 0 with weight 0. The table is
// float32 or bf16; weights and sums are float32 and the output, of the
// table's type, is rounded once.
//
// Three paths, picked per call by the plan (kernels/gather_combine.py):
//
//   * wide rows (bag_reduce_wide_kernel): a grid that fills the card
//     (serve_bulk's 262,144 bags) with rows of at least 32 16-byte columns
//     on 16-byte aligned bases. Each thread walks its bag's rows through
//     L1, which keeps the hot rows, two 16-byte columns a thread, with
//     each slot's (row, weight) pair one 8-byte shared load and 16 row
//     loads in flight before the first add. Past its bytes the row walk is
//     bound by its instructions per slot (a bf16 table took as long as a
//     float32 one with one column a thread), which the second column cuts.
//   * small grids (bag_reduce_small_kernel, bag_reduce.cuh): a call whose
//     usual grid cannot fill the card (one retrieve query).
//   * rows (bag_reduce_kernel, bag_reduce.cuh, shared with bag_combine):
//     every other shape, serve_p99 among them, where 16 rows a thread are
//     in flight before they are summed.
//
// Two designs lost to these and are gone (PERF.md section 6): copying each
// distinct row of a tile of bags into shared memory once by a TMA bulk
// copy (the copies issue one row at a time, and deduplicating within a
// tile saves fewer row reads than L1 already does across the bags a
// multiprocessor holds), and staging a serve_p99 bag's distinct rows in
// shared memory by cp.async, all in flight at once (no faster than the row
// walk's 16 rows in flight).
//
// Every path sums a bag's slots from slot 0 in order with __fmul_rn /
// __fadd_rn, so all three give bitwise the same result, and the same as
// bag_combine on the gathered rows.
#include <cstdint>

#include "bag_reduce.cuh"

// A 16-byte column of a row as it was loaded: its kN elements widened to
// float where they are added, and the store that rounds kN float sums once
// to the element type. (Kept apart from bag_reduce.cuh's BagCol: the wide
// kernel written with BagCol's column structs ran the bf16 bulk lookup 28%
// slower, and the float32 one no faster; PERF.md section 6.)
template <typename E> struct Col16;
template <> struct Col16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void from(uint4 q, float* v) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
  static __device__ __forceinline__ void store(float* p, const float* a) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
};
template <> struct Col16<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void from(uint4 q, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      v[2 * i] = t.x;
      v[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* a) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// block: bpb bags x tpb threads, tpb = cols / kWideCols; thread tx of a bag
// sums columns tx and tx + tpb (a warp's lanes on consecutive 16-byte
// columns, so each load instruction reads contiguous bytes of one row).
// Each chunk of a bag's slots is staged as (row, weight) pairs, one 8-byte
// shared load a slot; the slot loop is unrolled 8 times, so a thread has
// 16 row loads in flight before its first add.
constexpr int kWideCols = 2;
constexpr int kWideChunk = 64;
constexpr int kWideMaxBags = 16;
constexpr int kWideThreads = 256;

// E is float or __nv_bfloat16; cols: 16-byte columns a row.
template <typename E>
__global__ void __launch_bounds__(kWideThreads)
bag_reduce_wide_kernel(const E* __restrict__ table,
                       const int* __restrict__ idx,
                       const float* __restrict__ w, E* __restrict__ out,
                       long long n_bags, int d, int cols) {
  using C = Col16<E>;
  __shared__ int2 s_slot[kWideMaxBags][kWideChunk];
  const int tpb = cols / kWideCols;
  const int bpb = blockDim.x / tpb;
  const int by = threadIdx.x / tpb, tx = threadIdx.x - by * tpb;
  const long long b = static_cast<long long>(blockIdx.x) * bpb + by;
  const bool live = b < n_bags;
  const uint4* rows = reinterpret_cast<const uint4*>(table) + tx;
  float acc[kWideCols][C::kN];
#pragma unroll
  for (int k = 0; k < kWideCols; ++k)
#pragma unroll
    for (int i = 0; i < C::kN; ++i) acc[k][i] = 0.0f;
  for (int d0 = 0; d0 < d; d0 += kWideChunk) {
    const int nd = min(kWideChunk, d - d0);
    if (live) {
      for (int j = tx; j < nd; j += tpb) {
        const long long slot = b * d + d0 + j;
        s_slot[by][j] = make_int2(idx[slot], __float_as_int(w[slot]));
      }
    }
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int j = 0; j < nd; ++j) {
        const int2 e = s_slot[by][j];
        const uint4* r = rows + static_cast<long long>(e.x) * cols;
        const float wv = __int_as_float(e.y);
#pragma unroll
        for (int k = 0; k < kWideCols; ++k) {
          float v[C::kN];
          C::from(r[k * tpb], v);
#pragma unroll
          for (int i = 0; i < C::kN; ++i)
            acc[k][i] = __fadd_rn(acc[k][i], __fmul_rn(wv, v[i]));
        }
      }
    }
    __syncthreads();
  }
  if (live) {
    E* o = out + b * cols * C::kN;
#pragma unroll
    for (int k = 0; k < kWideCols; ++k)
      C::store(o + (tx + k * tpb) * C::kN, acc[k]);
  }
}

// The launch of kernels/gather_combine.py's plan. elem_bytes: 4 (float32
// table and out) or 2 (bf16); vec: 4 (float32) or 8 (bf16) where rows are
// 16-byte columns on aligned bases, else 1; path: BagPath. The wide path
// takes a 1-d block of whole bags of cols / kWideCols threads each, at most
// kWideMaxBags bags and kWideThreads threads, on 16-byte aligned bases;
// anything else is refused.
REPRO_EXPORT int gather_combine_launch(const void* table, const void* idx,
                                       const void* w, void* out,
                                       long long n_bags, int d, int f,
                                       int vec, int elem_bytes, int path,
                                       REPRO_LAUNCH_PARAMS) {
  ReproLaunch L;
  if (!repro_launch_dims(gx, gy, gz, bx, by, bz, smem_bytes, 1024, &L))
    return REPRO_BAD_LAUNCH;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = elem_bytes == 2;
  if (path == kWide) {
    const int row_bytes = f * elem_bytes;
    const int cols = row_bytes / 16;
    const int tpb = cols / kWideCols;
    if (row_bytes % 16 != 0 || cols % kWideCols != 0 || tpb < 1 ||
        bx > kWideThreads || bx % tpb != 0 || bx / tpb > kWideMaxBags ||
        by != 1 || bz != 1 || gy != 1 || gz != 1 || smem_bytes != 0 ||
        reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return REPRO_BAD_LAUNCH;
    if (bf16)
      bag_reduce_wide_kernel<__nv_bfloat16><<<L.grid, L.block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(table),
          static_cast<const int*>(idx), static_cast<const float*>(w),
          static_cast<__nv_bfloat16*>(out), n_bags, d, cols);
    else
      bag_reduce_wide_kernel<float><<<L.grid, L.block, 0, s>>>(
          static_cast<const float*>(table), static_cast<const int*>(idx),
          static_cast<const float*>(w), static_cast<float*>(out), n_bags, d,
          cols);
    return static_cast<int>(cudaGetLastError());
  }
  return bf16 ? bag_reduce_launch<true, __nv_bfloat16>(
                    table, idx, w, out, n_bags, d, f, vec, path, L, s)
              : bag_reduce_launch<true, float>(table, idx, w, out, n_bags, d,
                                               f, vec, path, L, s);
}

REPRO_EXPORT const void* gather_combine_kernel_of(const char* name) {
  if (std::strcmp(name, "bag_reduce_wide_kernel<float>") == 0)
    return reinterpret_cast<const void*>(bag_reduce_wide_kernel<float>);
  if (std::strcmp(name, "bag_reduce_wide_kernel<bf16>") == 0)
    return reinterpret_cast<const void*>(
        bag_reduce_wide_kernel<__nv_bfloat16>);
  const void* fn =
      bag_kernel_named<true, float, float4, float>(name, "float", "float4",
                                                    "float");
  if (fn == nullptr)
    fn = bag_kernel_named<true, __nv_bfloat16, Bf16x8, float>(
        name, "bf16", "bf16x8", "float");
  return fn;
}
