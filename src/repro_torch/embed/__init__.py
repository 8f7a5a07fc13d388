"""Partition-sharded sparse embedding tables (rows-as-vertices): twin of
``repro/embed``. The row co-access statistics, the shard plan
``partition()`` makes of them and the permuted table whose bag lookups run
the ``gather_combine`` kernel (``sharded_table``); a hot-row cache whose
hit/miss/traffic counters land in the ``[D, D]`` matrix shape the mapping
search scores, and touched-rows-only rowwise-Adagrad updates bitwise the
dense ones (``hot_cache``); the sparse train step (``training``); and an
async prefetching sampler overlapping host batch building with the step
(``prefetch``)."""
from repro_torch.embed.hot_cache import (HotRowCache, dense_row_update,
                                         masked_row_update,
                                         replicated_update_traffic,
                                         requester_of, sparse_row_update)
from repro_torch.embed.prefetch import PrefetchIterator
from repro_torch.embed.sharded_table import (RowAccessStats,
                                             ShardedEmbeddingTable, ShardPlan,
                                             identity_plan, plan_shards)
from repro_torch.embed.training import (EmbedConfig, init_dense_opt,
                                        init_embed_state,
                                        make_embed_train_step)

__all__ = [
    "RowAccessStats", "ShardPlan", "ShardedEmbeddingTable", "plan_shards",
    "identity_plan", "HotRowCache", "dense_row_update", "masked_row_update",
    "sparse_row_update", "replicated_update_traffic", "requester_of",
    "PrefetchIterator", "EmbedConfig", "init_embed_state", "init_dense_opt",
    "make_embed_train_step",
]
