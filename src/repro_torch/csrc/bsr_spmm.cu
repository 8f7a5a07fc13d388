// Block-sparse matrix product over BSR blocks (GIN's sum aggregation):
//
//     out[r*R + m, f] = sum over blocks t of block row r, in column order,
//                       sum over k of A_t[m, k] * x[cols[t]*R + k, f]
//
// Replaces the Pallas kernel repro/kernels/bsr_spmm.py:bsr_spmm. That
// kernel walks the nonzero blocks as a sequential grid axis and keeps a
// block row's output tile resident in VMEM from one grid step to the next;
// Hopper runs its blocks in no order, so the walk moves inside the block:
// one CUDA block per (block row, row tile, feature tile) loops over
// row_ptr[r] .. row_ptr[r+1] (the block-row pointers the host computes once
// per graph) in slabs of BK columns of A_t, and accumulates its output tile
// in registers, TM x TN values per thread. Each output element is written
// once, at the end: no atomics, no zero-fill pass, and a fixed summation
// order (blocks in column order, k ascending, one fmaf per term), so the
// result is deterministic. A block row without blocks writes zeros. Rows
// past R and columns past F are masked, so any R and F are taken.
//
// The slabs of A_t (stored k-major) and of the x tile go through two
// shared-memory buffers: while the block multiplies one slab, each thread
// holds its share of the next one in registers, loaded from device memory
// before the multiply and stored to the other buffer after it, so one
// memory latency per slab overlaps the arithmetic (one __syncthreads per
// slab). A small grid (a molecule request has 30 block rows) has too few
// blocks per multiprocessor to hide that latency any other way.
//
// Bound on the H100 (SXM, 700 W): at GIN-TU's bulk batch (16,384
// molecules, 3,840 block rows, 11,008 blocks of 128 x 128, F = 64) the
// function moves 721 MB of blocks plus x and out (126 MB each), 973 MB,
// 0.290 ms at 3.35 TB/s; the product needs one multiply-add per nonzero
// and feature, 2 * 1,947,010 * 64 = 0.25 GFLOP, 0.004 ms at the 67
// TFLOP/s float32 (non-tensor) peak. So it is bound by bytes. This kernel
// does every block's dense product, though, 2 * 11,008 * 128^2 * 64 =
// 23.1 GFLOP, 0.345 ms at that peak, more than the bytes take: the design
// spends it on fmaf in registers from shared memory, every block read
// from device memory once. The blocks of a molecule batch are ~1%
// nonzero; skipping their all-zero k-slabs (down towards the byte bound),
// wgmma with 3xTF32 and TMA staging are later speed work.
//
// Two tile shapes: 128 x 64 (128 threads, 8 x 8 each, 16-deep slabs) when
// its grid alone fills the card, else 32 x 32 (64 threads, 4 x 4 each,
// 32-deep slabs), which gives a 30-block-row molecule request 240 blocks
// instead of 30.
#include "common.cuh"

// This thread's share of one slab, device memory -> registers: A_t[m0 +
// m, k0 + k] for the BM x BK slab, x[k0 + k, f0 + c] for the BK x BN one,
// zero outside R x R and F.
template <int BM, int BN, int BK, int NT>
__device__ __forceinline__ void load_slab(float (&a_reg)[BM * BK / NT],
                                          float (&x_reg)[BK * BN / NT],
                                          const float* __restrict__ a,
                                          const float* __restrict__ xb,
                                          int m0, int k0, int f0, int r,
                                          int f, int tid) {
#pragma unroll
  for (int q = 0; q < BM * BK / NT; ++q) {
    const int i = tid + q * NT;           // consecutive threads along k
    const int gm = m0 + i / BK, gk = k0 + i % BK;
    a_reg[q] = (gm < r && gk < r) ? a[static_cast<long long>(gm) * r + gk]
                                  : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < BK * BN / NT; ++q) {
    const int i = tid + q * NT;           // consecutive threads along f
    const int gk = k0 + i / BN, gc = f0 + i % BN;
    x_reg[q] = (gk < r && gc < f) ? xb[static_cast<long long>(gk) * f + gc]
                                  : 0.0f;
  }
}

// Registers -> one shared buffer (A k-major, so the multiply reads TM
// consecutive rows at one k).
template <int BM, int BN, int BK, int NT>
__device__ __forceinline__ void store_slab(float (*a_s)[BM + 4],
                                           float (*x_s)[BN + 4],
                                           const float (&a_reg)[BM * BK / NT],
                                           const float (&x_reg)[BK * BN / NT],
                                           int tid) {
#pragma unroll
  for (int q = 0; q < BM * BK / NT; ++q) {
    const int i = tid + q * NT;
    a_s[i % BK][i / BK] = a_reg[q];
  }
#pragma unroll
  for (int q = 0; q < BK * BN / NT; ++q) {
    const int i = tid + q * NT;
    x_s[i / BN][i % BN] = x_reg[q];
  }
}

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
bsr_spmm_kernel(const int* __restrict__ row_ptr,
                const int* __restrict__ cols,
                const float* __restrict__ blocks,
                const float* __restrict__ x, float* __restrict__ out, int r,
                int f, int m_tiles) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int kColGroups = BN / TN;
  static_assert((BM * BK) % NT == 0 && (BK * BN) % NT == 0,
                "every thread loads the same share of a slab");
  // two buffers; +4 keeps each row 16-byte aligned for vector reads
  __shared__ __align__(16) float a_s[2][BK][BM + 4];
  __shared__ __align__(16) float x_s[2][BK][BN + 4];
  const int brow = blockIdx.x / m_tiles;
  const int m0 = (blockIdx.x - brow * m_tiles) * BM;
  const int f0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int row0 = (tid / kColGroups) * TM;
  const int col0 = (tid % kColGroups) * TN;
  const long long rr = static_cast<long long>(r) * r;
  const long long rf = static_cast<long long>(r) * f;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  float a_reg[BM * BK / NT], x_reg[BK * BN / NT];
  int t = row_ptr[brow], k0 = 0;          // the slab in buffer s & 1
  const int n_slabs = (row_ptr[brow + 1] - t) * ((r + BK - 1) / BK);
  if (n_slabs > 0) {
    load_slab<BM, BN, BK, NT>(a_reg, x_reg, blocks + t * rr, x + cols[t] * rf,
                              m0, 0, f0, r, f, tid);
    store_slab<BM, BN, BK, NT>(a_s[0], x_s[0], a_reg, x_reg, tid);
  }
  __syncthreads();
  for (int s = 0; s < n_slabs; ++s) {
    const int buf = s & 1;
    int t_next = t, k_next = k0 + BK;     // the slab after this one
    if (k_next >= r) {
      k_next = 0;
      ++t_next;
    }
    const bool more = s + 1 < n_slabs;
    if (more)
      load_slab<BM, BN, BK, NT>(a_reg, x_reg, blocks + t_next * rr,
                                x + cols[t_next] * rf, m0, k_next, f0, r, f,
                                tid);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], xv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a_s[buf][k][row0 + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) xv[j] = x_s[buf][k][col0 + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
    }
    if (more)
      store_slab<BM, BN, BK, NT>(a_s[buf ^ 1], x_s[buf ^ 1], a_reg, x_reg,
                                 tid);
    __syncthreads();
    t = t_next;
    k0 = k_next;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + row0 + i;
    if (gm >= r) continue;
    float* o = out + (static_cast<long long>(brow) * r + gm) * f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = f0 + col0 + j;
      if (gc < f) o[gc] = acc[i][j];
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
static void bsr_spmm_enqueue(const int* row_ptr, const int* cols,
                             const float* blocks, const float* x, float* out,
                             int n_block_rows, int r, int f,
                             cudaStream_t stream) {
  const int m_tiles = (r + BM - 1) / BM;
  dim3 grid(static_cast<unsigned>(n_block_rows) * m_tiles,
            (f + BN - 1) / BN);
  bsr_spmm_kernel<BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(row_ptr, cols, blocks, x,
                                                   out, r, f, m_tiles);
}

// wide != 0: the 128 x 64 tile, else the 32 x 32 one (the wrapper picks).
REPRO_EXPORT int bsr_spmm_launch(const void* row_ptr, const void* cols,
                                 const void* blocks, const void* x, void* out,
                                 int n_block_rows, int r, int f, int wide,
                                 void* stream) {
  if (n_block_rows == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto rp = static_cast<const int*>(row_ptr);
  auto cl = static_cast<const int*>(cols);
  auto bl = static_cast<const float*>(blocks);
  auto xx = static_cast<const float*>(x);
  auto o = static_cast<float*>(out);
  if (wide)
    bsr_spmm_enqueue<128, 64, 16, 8, 8>(rp, cl, bl, xx, o, n_block_rows, r, f,
                                        s);
  else
    bsr_spmm_enqueue<32, 32, 32, 4, 4>(rp, cl, bl, xx, o, n_block_rows, r, f,
                                       s);
  return static_cast<int>(cudaGetLastError());
}
