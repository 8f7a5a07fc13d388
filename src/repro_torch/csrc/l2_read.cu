// The card's L2 read rate, for the gather kernel's every-slot bound: every
// thread reads a buffer that fits L2 (the smoke run passes 40 MB) in
// 16-byte loads that bypass L1 (ld.global.cg), `reps` times over, after
// one pass that brings it into L2. Not a kernel of the port: chip_smoke.py
// times it once and reports bytes read over device time.
#include "common.cuh"

__global__ void l2_read_kernel(const float4* __restrict__ buf, long long n4,
                               int reps, float* __restrict__ sink) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float acc = 0.0f;
  for (int rep = 0; rep < reps; ++rep) {
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         i < n4; i += 4 * stride) {
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = i + k * stride < n4 ? __ldcg(buf + i + k * stride)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc += v[k].x + v[k].y + v[k].z + v[k].w;
    }
  }
  if (acc == -1.0f) sink[0] = acc;   // keeps the loads; never true for >= 0
}

REPRO_EXPORT int l2_read_launch(const void* buf, long long bytes, int reps,
                                void* sink, int n_sm, void* stream) {
  l2_read_kernel<<<n_sm * 4, 512, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(buf), bytes / 16, reps,
      static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}
