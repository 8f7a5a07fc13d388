"""Partition-sharded sparse embedding tables (rows-as-vertices): the row
co-access statistics, the shard plan ``partition()`` makes of them, and the
permuted table whose bag lookups run the ``gather_combine`` kernel. Twin of
``repro/embed/sharded_table.py``; the hot-row cache, prefetcher and sparse
training of ``repro/embed`` are not ported yet."""
from repro_torch.embed.sharded_table import (RowAccessStats,  # noqa: F401
                                             ShardedEmbeddingTable, ShardPlan,
                                             identity_plan, plan_shards)
