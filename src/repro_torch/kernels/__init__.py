"""Hand-written Hopper (sm_90a) kernels of the port and their dispatch.

One module per kernel, each holding the wrapper that launches
``csrc/<name>.cu`` on CUDA tensors, the plain PyTorch version that CPU
tensors run, a launch counter (``launches``) and a note on the TPU kernel it
replaces. ``ops.py`` is the public API; ``build.py`` compiles the sources
with ``nvcc`` at first use and loads them with ``ctypes``.

Kernels (the partitioner's main path):
  * ``match_keys`` — jittered masked arc keys of device heavy-edge matching,
    and ``match_round``, the whole matching round fused (the coarsening
    path's kernel).
  * ``bucket_assign`` — capacity-boundary bucket search of the device
    initial partition, and ``prefix_split``, the whole capacity-prefix
    split (scan, midpoints, count, clip) fused (the initial partition's
    kernel).
  * ``quotient_link_loads`` — the paper's objective: arc list -> per-link
    communication load.
  * ``partition_gain`` — the dense refinement round's ``[n, k]``
    connectivity rows (ELL).

Kernels (the two-tower serving path):
  * ``bag_combine`` — the weighted bag reduction of ``embedding_bag`` over
    pre-gathered rows (``TwoTower`` user tower input), float32 or bf16.
  * ``gather_combine`` — the same reduction with the row gather fused
    (``ShardedEmbeddingTable.lookup_bags``), on float32 or bf16 tables.

Kernel (the GIN path):
  * ``bsr_spmm`` — block-sparse ``A @ X`` over a BSR layout's 128 x 128
    blocks, one CUDA block per (block row, row tile, feature tile) walking
    the block-row pointers (GIN's sum aggregation,
    ``ops.gnn_aggregate_bsr``).

Kernel (the LM path):
  * ``flash_attention`` — the online-softmax attention forward with GQA,
    one CUDA block per (batch, head, 64-row q tile) walking the kv tiles
    (every layer of the transformer's ``forward`` / ``prefill``).
"""
