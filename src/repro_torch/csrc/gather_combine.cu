// Fused embedding-bag gather + combine (ShardedEmbeddingTable.lookup_bags):
//
//     out[b, f] = sum over slots d of w[b, d] * table[idx[b, d], f]
//
// Replaces the Pallas kernel repro/kernels/gather_combine.py:gather_combine,
// which scalar-prefetches the ids and DMAs one row tile per sequential grid
// step into a resident output block. Here a block loads its own bags' ids,
// and the slot axis is a loop inside the block (bag_reduce.cuh). Bound: the
// rows the bags name (F*4 bytes per slot; hot rows of a Zipf stream are
// read once from device memory and then from L2), the ids and weights
// (8 bytes per slot) and the output (F*4 bytes per bag). Ids must lie in
// [0, V): callers map padding to row 0 with weight 0.
#include "bag_reduce.cuh"

REPRO_EXPORT int gather_combine_launch(const void* table, const void* idx,
                                       const void* w, void* out,
                                       long long n_bags, int d, int f,
                                       int vec, int sms, void* stream) {
  return bag_reduce_launch<true>(table, idx, w, out, n_bags, d, f, vec, sms,
                                 stream);
}
