// Connectivity rows of the dense refinement round (core/refine.py):
//
//     conn[v, j] = sum over ELL slots d of w[v, d] * [part[nbr[v, d]] = j]
//
// Replaces the Pallas kernel repro/kernels/partition_gain.py:
// partition_gain_ell and fuses the part[nbr_idx] gather of
// repro/kernels/ops.py:partition_gain_pallas. Padding slots hold the
// sentinel neighbour id n (weight 0) and are skipped, as bin k is in the
// TPU kernel's one-hot.
//
// A block owns a tile of `rows` rows (kernels/partition_gain.py: tile picks
// it so the grid covers the SMs). The tile's [rows, D] slots of nbr_idx and
// nbr_w are contiguous: the block copies them in one coalesced pass, each
// thread keeping kSlotsPerThread slots' loads in flight, then gathers
// part[u] for every slot at once into shared memory. A call so waits
// through about three device-memory latencies (ids, bins, the write), not
// two per slot. Then one thread per (row, bin) scans its row's staged slots
// in slot order from +0, so each sum is the in-order float32 sum (bitwise
// np.add.at), and conn is written once, coalesced. Rows whose slots do not
// fit the staging buffer are done in chunks of slots, the partial sums
// carried in conn by the thread that owns them.
//
// Bound: the ELL arrays are read once (8 B per slot), part is gathered
// (4 B per vertex) and conn written once (4 B per entry): n*D*8 + n*4 +
// n*k*4 bytes over device memory.
#include "common.cuh"

namespace {

constexpr int kSlotsPerThread = 4;

__global__ void __launch_bounds__(256) partition_gain_kernel(
    const int* __restrict__ part, const int* __restrict__ nbr_idx,
    const float* __restrict__ nbr_w, float* conn, int n, int d, int k,
    int rows, int d_chunk) {
  extern __shared__ int s_bin[];                     // [rows * d_chunk]
  float* s_w = reinterpret_cast<float*>(s_bin + rows * d_chunk);
  const int t = threadIdx.x, n_threads = blockDim.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int live = n - row0 < rows ? static_cast<int>(n - row0) : rows;
  const int outs = live * k;
  float* out = conn + row0 * k;
  int c0 = 0;
  do {                                       // once even for D = 0
    const int dc = d - c0 < d_chunk ? d - c0 : d_chunk;
    const int slots = live * dc;
    if (c0) __syncthreads();                 // the last chunk's scans are done
    for (int s0 = t; s0 < slots; s0 += n_threads * kSlotsPerThread) {
      int u[kSlotsPerThread];
      float w[kSlotsPerThread];
#pragma unroll
      for (int q = 0; q < kSlotsPerThread; ++q) {
        const int s = s0 + q * n_threads;
        u[q] = n;
        w[q] = 0.0f;
        if (s < slots) {
          const int r = s / dc;
          const long long g = (row0 + r) * d + c0 + (s - r * dc);
          u[q] = __ldg(nbr_idx + g);
          w[q] = __ldg(nbr_w + g);
        }
      }
#pragma unroll
      for (int q = 0; q < kSlotsPerThread; ++q) {
        const int s = s0 + q * n_threads;
        if (s < slots) {
          s_bin[s] = static_cast<unsigned>(u[q]) < static_cast<unsigned>(n)
                         ? __ldg(part + u[q])
                         : -1;
          s_w[s] = w[q];
        }
      }
    }
    __syncthreads();
    for (int o = t; o < outs; o += n_threads) {
      const int r = o / k, j = o - r * k;
      const int* bins = s_bin + r * dc;
      const float* ws = s_w + r * dc;
      float acc = c0 ? out[o] : 0.0f;
      for (int q = 0; q < dc; ++q)
        if (bins[q] == j) acc += ws[q];
      out[o] = acc;
    }
    c0 += d_chunk;
  } while (c0 < d);
}

}  // namespace

// The launch of kernels/partition_gain.py's plan: `rows` rows a block,
// `d_chunk` slots of a row staged at once, shared memory rows * d_chunk * 8
// bytes (refused if the plan's differs).
REPRO_EXPORT int partition_gain_launch(const void* part, const void* nbr_idx,
                                       const void* nbr_w, void* conn, int n,
                                       int d, int k, int rows, int d_chunk,
                                       REPRO_LAUNCH_PARAMS) {
  ReproLaunch L;
  if (!repro_launch_dims(gx, gy, gz, bx, by, bz, smem_bytes, 256, &L) ||
      rows < 1 || d_chunk < 1 ||
      smem_bytes != static_cast<long long>(rows) * d_chunk * 8)
    return REPRO_BAD_LAUNCH;
  partition_gain_kernel<<<L.grid, L.block, L.smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(part), static_cast<const int*>(nbr_idx),
      static_cast<const float*>(nbr_w), static_cast<float*>(conn), n, d, k,
      rows, d_chunk);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT const void* partition_gain_kernel_of(const char* name) {
  return std::strcmp(name, "partition_gain_kernel") == 0
             ? reinterpret_cast<const void*>(partition_gain_kernel)
             : nullptr;
}
