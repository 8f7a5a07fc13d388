// Weighted bag reduction over pre-gathered rows (TwoTower's embedding bag):
//
//     out[b, f] = sum over slots d of w[b, d] * g[b, d, f]
//
// Replaces the Pallas kernel repro/kernels/bag_combine.py:bag_combine, a
// batched vec-mat on the TPU's matrix unit over (bag tile, feature tile).
// At ~0.5 flop per byte this is a streaming reduction, not a matrix
// product: bound by reading g once (B*D*F*4 bytes) and writing out. It
// shares its block shape and its in-order __fmul_rn/__fadd_rn accumulation
// with gather_combine (bag_reduce.cuh), so the two agree bitwise.
#include "bag_reduce.cuh"

REPRO_EXPORT int bag_combine_launch(const void* g, const void* w, void* out,
                                    long long n_bags, int d, int f, int vec,
                                    void* stream) {
  return bag_reduce_launch<false>(g, nullptr, w, out, n_bags, d, f, vec,
                                  stream);
}
