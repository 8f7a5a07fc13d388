// Jittered, masked heavy-edge matching keys (one match round of
// core/coarsen.py:coarsen_device):
//
//     key[a] = w[a] * (1 + 0.01 * u[a])   if mask[a] > 0   else -1
//
// Replaces the Pallas kernel repro/kernels/match_keys.py:match_keys_tiled.
// Pure streaming map: 12 B read + 4 B written per arc, no reuse, so the card
// is bound by device-memory bytes. One thread per arc, grid-stride, adjacent
// threads on adjacent words (coalesced). The arithmetic uses the _rn
// intrinsics so nvcc cannot contract it into an FMA: the result is then
// bit-identical to the plain PyTorch version (separate mul/add/mul).
#include "common.cuh"

__global__ void match_keys_kernel(const float* __restrict__ w,
                                  const float* __restrict__ u,
                                  const float* __restrict__ mask,
                                  float* __restrict__ out, long long m) {
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long a = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       a < m; a += stride) {
    float jitter = __fadd_rn(1.0f, __fmul_rn(0.01f, u[a]));
    float key = __fmul_rn(w[a], jitter);
    out[a] = mask[a] > 0.0f ? key : -1.0f;
  }
}

// The launch of kernels/match_keys.py's plan: a 1-d grid-stride grid.
REPRO_EXPORT int match_keys_launch(const void* w, const void* u,
                                   const void* mask, void* out, long long m,
                                   REPRO_LAUNCH_PARAMS) {
  ReproLaunch L;
  if (!repro_launch_dims(gx, gy, gz, bx, by, bz, smem_bytes, 1024, &L) ||
      gy != 1 || gz != 1 || by != 1 || bz != 1)
    return REPRO_BAD_LAUNCH;
  match_keys_kernel<<<L.grid, L.block, L.smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(mask), static_cast<float*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// One whole matching round (core/coarsen.py:coarsen_step), fused:
//
//     live[a]     = mask[a] > 0 and key[a] > 0, where mask[a] is the product
//                   of the 0/1 eligibilities of s[a] and r[a] and [w > 0]
//     best_arc[v] = the live arc of sender v with the largest key, the
//                   largest arc id among equal keys; -1 where v has none
//
// which the reference computes as the keys above, a segment_max of the keys
// by sender, a second segment_max of the arc ids attaining it, and the
// gathers and products between them (src/repro/core/coarsen.py:138-151):
// about ten launches a round, each arc's data crossing device memory about
// eight times. Here the key never leaves registers: each live arc packs
// (key bits << 32) | arc id into one 64-bit word, whose unsigned order is
// the (key, arc id) order because positive float bits order as unsigned
// integers, and the words of one sender meet in one atomicMax. Max is
// order-free, so every run gives the same answer. The arcs are CSR-sorted
// by sender, so a warp first takes the maximum over each run of equal
// senders among its 32 lanes (a segmented shuffle scan) and only the last
// lane of a run issues the atomic: a hub row of 10,000 arcs costs ~300
// atomics on its word, not 10,000. Unsorted senders stay correct, with
// more atomics.
//
// One cooperative launch: the arcs (grid-stride, 4 arcs a lane in flight),
// one grid barrier, then every vertex's word is turned into best_arc and
// set back to zero, so the word buffer (owned by the wrapper, zeroed once)
// is zero again for the next call. Calls sharing the buffer must be
// ordered, so the wrapper uses it on the current stream only.
//
// Bound: 16 B per arc (s, r, w, u), the matched flags once per vertex, the
// word buffer (8 B per vertex) and best_arc (4 B per vertex).
constexpr int kRoundArcs = 4;    // arcs a lane keeps in flight
constexpr int kRoundThreads = 512;

// The blocks of one launch meet here: `count` returns to 0 after every
// barrier, `gen` counts barriers. Blocks must all be resident (cooperative
// launch).
static __device__ __forceinline__ void round_grid_barrier(unsigned* count,
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

__global__ void __launch_bounds__(kRoundThreads, 2)
match_round_kernel(const int* __restrict__ s, const int* __restrict__ r,
                   const float* __restrict__ w, const float* __restrict__ u,
                   const unsigned char* __restrict__ matched,
                   int* __restrict__ best, unsigned long long* words,
                   unsigned* bar, long long m, int n) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  constexpr long long kSpan = 32 * kRoundArcs;
  for (long long base = warp * kSpan; base < m; base += n_warps * kSpan) {
    int sa[kRoundArcs], ra[kRoundArcs];
    float wa[kRoundArcs], ua[kRoundArcs];
#pragma unroll
    for (int j = 0; j < kRoundArcs; ++j) {
      const long long a = base + j * 32 + lane;
      const bool ok = a < m;
      sa[j] = ok ? __ldg(s + a) : -1;
      ra[j] = ok ? __ldg(r + a) : 0;
      wa[j] = ok ? __ldg(w + a) : 0.0f;
      ua[j] = ok ? __ldg(u + a) : 0.0f;
    }
    float es[kRoundArcs], er[kRoundArcs];
#pragma unroll
    for (int j = 0; j < kRoundArcs; ++j) {
      const bool ok = sa[j] >= 0;
      es[j] = ok && !__ldg(matched + sa[j]) ? 1.0f : 0.0f;
      er[j] = ok && !__ldg(matched + ra[j]) ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kRoundArcs; ++j) {
      const long long a = base + j * 32 + lane;
      const float mask = __fmul_rn(__fmul_rn(es[j], er[j]),
                                   wa[j] > 0.0f ? 1.0f : 0.0f);
      const float key = __fmul_rn(wa[j], __fadd_rn(1.0f,
                                                   __fmul_rn(0.01f, ua[j])));
      const bool live = mask > 0.0f && key > 0.0f;
      unsigned long long word =
          live ? (static_cast<unsigned long long>(__float_as_uint(key)) << 32)
                     | static_cast<unsigned>(a)
               : 0ull;
      // the maximum over the run of equal senders ending at this lane
      const int seg = sa[j];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int so = __shfl_up_sync(0xffffffffu, seg, off);
        const unsigned long long wo = __shfl_up_sync(0xffffffffu, word, off);
        if (lane >= off && so == seg && wo > word) word = wo;
      }
      const int next = __shfl_down_sync(0xffffffffu, seg, 1);
      if (seg >= 0 && word != 0ull && (lane == 31 || next != seg))
        atomicMax(words + seg, word);
    }
  }
  round_grid_barrier(bar, bar + 1);
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < n; v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned long long word = __ldcg(words + v);
    best[v] = word ? static_cast<int>(static_cast<unsigned>(word)) : -1;
    if (word) words[v] = 0ull;
  }
}

// One cooperative launch of kernels/match_keys.py's round plan: gx blocks
// of bx threads (a whole number of warps, at most kRoundThreads); a grid
// the card cannot hold at once is refused by the launch, never cut.
// `work`: one 64-bit word holding the two barrier words, then at least n
// zeroed 64-bit words, all zero before the first call; every call leaves
// the n words zero again and the barrier ready.
REPRO_EXPORT int match_round_launch(const void* s, const void* r,
                                    const void* w, const void* u,
                                    const void* matched, void* best,
                                    void* work, long long m, int n,
                                    REPRO_LAUNCH_PARAMS) {
  ReproLaunch L;
  if (!repro_launch_dims(gx, gy, gz, bx, by, bz, smem_bytes, kRoundThreads,
                         &L) ||
      gy != 1 || gz != 1 || by != 1 || bz != 1 || bx % 32 != 0)
    return REPRO_BAD_LAUNCH;
  const int* p_s = static_cast<const int*>(s);
  const int* p_r = static_cast<const int*>(r);
  const float* p_w = static_cast<const float*>(w);
  const float* p_u = static_cast<const float*>(u);
  const unsigned char* p_m = static_cast<const unsigned char*>(matched);
  int* p_best = static_cast<int*>(best);
  unsigned* p_bar = static_cast<unsigned*>(work);
  unsigned long long* p_words = static_cast<unsigned long long*>(work) + 1;
  void* args[] = {&p_s, &p_r, &p_w, &p_u, &p_m, &p_best, &p_words, &p_bar,
                  &m, &n};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(match_round_kernel), L.grid, L.block, args,
      L.smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return repro_fail(e);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT const void* match_keys_kernel_of(const char* name) {
  return std::strcmp(name, "match_keys_kernel") == 0
             ? reinterpret_cast<const void*>(match_keys_kernel)
             : nullptr;
}

REPRO_EXPORT const void* match_round_kernel_of(const char* name) {
  return std::strcmp(name, "match_round_kernel") == 0
             ? reinterpret_cast<const void*>(match_round_kernel)
             : nullptr;
}
