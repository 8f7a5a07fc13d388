// Weighted bag reduction over pre-gathered rows (TwoTower's embedding bag):
//
//     out[b, f] = sum over slots d of w[b, d] * g[b, d, f]
//
// Replaces the Pallas kernel repro/kernels/bag_combine.py:bag_combine, a
// batched vec-mat on the TPU's matrix unit over (bag tile, feature tile).
// At ~0.5 flop per byte this is a streaming reduction, not a matrix
// product: bound by reading g once (B*D*F*4 bytes) and writing out. It
// shares its block shape and its in-order __fmul_rn/__fadd_rn accumulation
// with gather_combine (bag_reduce.cuh), so the two agree bitwise. Rows and
// weights are both float32 or both bf16 (elem: bytes per element, 4 or 2),
// as the reference takes the input's dtype; bf16 rows and weights are
// widened as they are read, summed in float32 and rounded once to bf16.
#include "bag_reduce.cuh"

// The launch of kernels/bag_combine.py's plan; path: BagPath (no kWide).
REPRO_EXPORT int bag_combine_launch(const void* g, const void* w, void* out,
                                    long long n_bags, int d, int f, int vec,
                                    int elem, int path,
                                    REPRO_LAUNCH_PARAMS) {
  ReproLaunch L;
  if (!repro_launch_dims(gx, gy, gz, bx, by, bz, smem_bytes, 1024, &L) ||
      path == kWide)
    return REPRO_BAD_LAUNCH;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 2)
    return bag_reduce_launch<false, __nv_bfloat16, __nv_bfloat16>(
        g, nullptr, w, out, n_bags, d, f, vec, path, L, s);
  return bag_reduce_launch<false>(g, nullptr, w, out, n_bags, d, f, vec, path,
                                  L, s);
}

REPRO_EXPORT const void* bag_combine_kernel_of(const char* name) {
  const void* fn =
      bag_kernel_named<false, float, float4, float>(name, "float", "float4",
                                                     "float");
  if (fn == nullptr)
    fn = bag_kernel_named<false, __nv_bfloat16, Bf16x8, __nv_bfloat16>(
        name, "bf16", "bf16x8", "bf16");
  return fn;
}
