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

REPRO_EXPORT int bag_combine_launch(const void* g, const void* w, void* out,
                                    long long n_bags, int d, int f, int vec,
                                    int elem, int sms, void* stream) {
  if (elem == 2)
    return bag_reduce_launch<false, __nv_bfloat16, __nv_bfloat16>(
        g, nullptr, w, out, n_bags, d, f, vec, sms, stream);
  return bag_reduce_launch<false>(g, nullptr, w, out, n_bags, d, f, vec, sms,
                                  stream);
}

// Whether both bag kernels take the small-grid path at this shape on a card
// of sms multiprocessors (1) or not (0): the launchers' own rule, exported
// for the card tests.
REPRO_EXPORT int bag_reduce_small_grid(long long n_bags, int f, int vec,
                                       int sms) {
  return bag_small_grid(n_bags, f, vec, sms) ? 1 : 0;
}
