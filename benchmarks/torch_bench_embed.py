"""Embedding-table deployment bench on the port: replicated against
partition-sharded against sharded + hot-row cache against + async
prefetch, on one Zipf lookup/update stream over the heterogeneous
``tpu-mixed-32`` machine model. Twin of ``bench_embed.py`` over
``repro_torch``; its rows land in ``BENCH_torch_embed.json`` in the
working directory. Run from the repository's root:

    PYTHONPATH=src python -m benchmarks.torch_bench_embed
    REPRO_BENCH_DEVICE=cpu REPRO_BENCH_TINY=1 PYTHONPATH=src \\
        python -m benchmarks.torch_bench_embed

The bench's gates are the reference's: it raises when the sharded +
cached deployment's measured bytes (miss fetches and update writebacks,
both sides of the wire) are not strictly below the replicated baseline
(every touched row's gradient broadcast to the other ``D - 1`` replicas),
and when the prefetcher never ran a batch ahead of its consumer
(``max_occupancy >= 1``). Lookups run ``embedding_bag`` (the replicated
table) and ``lookup_bags`` (the sharded one): the ``bag_combine`` and
``gather_combine`` kernels on the card.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from benchmarks.torch_common import TINY, bench_device, emit, tiny
from repro_torch import embed
from repro_torch.kernels import ops as kops

MACHINE = "tpu-mixed-32"


def _batches(v, batch, hist, n_batches, seed=0, zipf_a=1.1):
    """[B, H] Zipf id bags with -1 padding, one list (replayed per row)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, v + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    out = []
    for _ in range(n_batches):
        ids = rng.choice(v, size=(batch, hist), p=probs)
        drop = rng.random(ids.shape) < 0.2
        out.append(np.where(drop, -1, ids).astype(np.int32))
    return out


def _bag_weights(ids):
    valid = ids >= 0
    lens = np.maximum(valid.sum(-1, keepdims=True), 1)
    return (valid / lens).astype(np.float32)


def _flat_ids(ids, n_devices):
    """Valid ids + their requesting device (contiguous batch split)."""
    req_row = embed.requester_of(ids.shape[0], n_devices)
    valid = ids >= 0
    return ids[valid], np.broadcast_to(req_row[:, None], ids.shape)[valid]


def _drive(cache, batches, accum, lr=0.05):
    """One epoch of lookups + sparse updates through the cache."""
    e = cache.table.dim
    rng = np.random.default_rng(1)
    for ids in batches:
        flat, req = _flat_ids(ids, cache.n_devices)
        cache.lookup(flat, req)
        rows, first = np.unique(flat, return_index=True)
        grads = rng.normal(0, 1, (rows.shape[0], e)).astype(np.float32)
        accum = cache.apply_grads(rows, grads, accum, req[first], lr=lr)
    cache.check_invariants()
    cache.flush()
    return accum


def _timed_lookups(fn, dev) -> float:
    fn()                                   # first call untimed
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def embed_deployments(device=None) -> list:
    dev = torch.device(device or bench_device())
    v, e, hist, batch, n_batches, n_cache = tiny(
        (20_000, 64, 24, 64, 32, 1024), (2_000, 16, 8, 16, 8, 128))
    batches = _batches(v, batch, hist, n_batches)
    stats = embed.RowAccessStats(v)
    for ids in batches[:max(4, n_batches // 4)]:
        stats.record(ids)
    plan = embed.plan_shards(stats, machine=MACHINE, device=dev)
    plan.check()
    d = plan.n_devices
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.normal(0, 0.1, (v, e)).astype(np.float32),
                            device=dev)
    row_bytes = e * 4
    dev_batches = [(torch.as_tensor(ids, device=dev),
                    torch.as_tensor(_bag_weights(ids), device=dev))
                   for ids in batches]
    rows = []

    # -- replicated baseline: local lookups, broadcast updates ----------
    def rep_lookups():
        out = None
        for ids, w in dev_batches:
            out = kops.embedding_bag(table, ids.clamp_min(0), w)
        return out

    rep_lookup_s = _timed_lookups(rep_lookups, dev)
    rep_traffic = 0.0
    for ids in batches:
        flat, req = _flat_ids(ids, d)
        rep_traffic += embed.replicated_update_traffic(
            flat, req, d, row_bytes).sum() / 2
    emit("embed", "replicated", rep_lookup_s,
         traffic_mb=round(rep_traffic / 2 ** 20, 3))
    rows.append({"name": "replicated", "lookup_s": rep_lookup_s,
                 "traffic_bytes": float(rep_traffic)})

    # -- sharded (no cache / cache / cache + prefetch) -------------------
    def sharded_row(name, cache_rows, stream):
        st = embed.ShardedEmbeddingTable(table, plan)
        cache = embed.HotRowCache(st, n_cache=cache_rows, policy="lru")
        if cache_rows:
            cache.warm(stats.top_rows(cache_rows))

        def lookups():
            out = None
            for ids, w in dev_batches:
                out = st.lookup_bags(ids, w)
            return out

        lookup_s = _timed_lookups(lookups, dev)
        _drive(cache, stream, torch.zeros(v, device=dev))
        row = {"name": name, "lookup_s": lookup_s,
               "traffic_bytes": cache.traffic_bytes(),
               "hit_rate": round(cache.hit_rate, 4),
               "cache_rows": cache_rows}
        emit("embed", name, lookup_s,
             traffic_mb=round(cache.traffic_bytes() / 2 ** 20, 3),
             hit_rate=row["hit_rate"])
        rows.append(row)
        return row

    sharded_row("sharded", 0, batches)
    cached = sharded_row("sharded_cache", n_cache, batches)

    pf = embed.PrefetchIterator(iter(batches), depth=2)
    prefetched = sharded_row("sharded_cache_prefetch", n_cache, pf)
    pf.close()
    prefetched["max_occupancy"] = pf.stats()["max_occupancy"]

    # -- the subsystem's claims: fail the bench if they break -----------
    if cached["traffic_bytes"] >= rep_traffic:
        raise AssertionError(
            f"sharded+cache traffic {cached['traffic_bytes']:.0f} B is "
            f"not below the replicated baseline {rep_traffic:.0f} B")
    if prefetched["max_occupancy"] < 1:
        raise AssertionError(
            "prefetcher never ran ahead of the consumer "
            f"(max_occupancy={prefetched['max_occupancy']})")
    if not np.array_equal(np.sort(plan.row_to_device),
                          plan.row_to_device[plan.order]):
        raise AssertionError("shard permutation is not device-contiguous")
    return rows


def run() -> None:
    rows = embed_deployments()
    out = {"embed": rows, "tiny": TINY, "device": bench_device()}
    with open("BENCH_torch_embed.json", "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote BENCH_torch_embed.json ({len(rows)} rows)")


if __name__ == "__main__":
    run()
