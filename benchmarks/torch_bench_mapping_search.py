"""Looped against batched candidate scoring of the mesh-mapping search, on
the port. Twin of ``bench_mapping_search.py`` over ``repro_torch``.

The looped scorer is the canonical path: one ``makespan_tree`` call (one
``quotient_link_loads`` launch on the card) and one sync per candidate.
The batched scorer (``core.mapping.score_device_maps``) buckets every
candidate's traffic pairs with two flat ``index_add_`` calls and reduces
to link loads with two products, per chunk of 128 candidates. The two are
held to ``rtol 1e-3, atol 1e-4 * max|looped|`` per candidate. Then one
search per machine preset (searched <= identity asserted, on the
capacity-normalised makespan too) and a best-of-S ``partition`` row.
Writes ``BENCH_torch_mapping_search.json``. Run from the repository's
root:

    PYTHONPATH=src python -m benchmarks.torch_bench_mapping_search
    REPRO_BENCH_DEVICE=cpu REPRO_BENCH_TINY=1 PYTHONPATH=src \\
        python -m benchmarks.torch_bench_mapping_search
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from benchmarks.torch_common import bench_device, emit, tiny
from repro_torch.core import mapping
from repro_torch.core.machine import MachineSpec
from repro_torch.core.topology import mesh_tree

SHAPES = tiny([(4, 4), (2, 16), (4, 4, 4), (2, 16, 16), (8, 8, 8)],
              [(2, 4), (2, 2, 4)])
SEEDS = tiny(4, 2)
MACHINES = tiny(["tpu_v5e-512", "gpu-superpod", "torus-2d", "tpu-mixed-32"],
                ["gpu-superpod", "tpu-mixed-32"])
N_RANDOM = tiny(16, 4)


def _traffic(shape) -> np.ndarray:
    """Ring-model traffic with per-axis bytes spanning 3 decades."""
    axis_bytes = {a: 10.0 ** (3 - a) for a in range(len(shape))}
    return mapping.collective_traffic_matrix(shape, axis_bytes)


def _score_looped(T, topo, cands, edges, dev) -> np.ndarray:
    return np.asarray([float(mapping._device_map_breakdown(
        T, topo, c, edges, dev).comm_max) for c in cands])


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def score_row(shape, dev) -> dict:
    """Batched against looped scores of every candidate of ``shape`` on
    ``mesh_tree(shape)``, each timed once after a warm-up; raises unless
    they agree to ``rtol 1e-3, atol 1e-4 * max|looped|``."""
    topo = mesh_tree(shape)
    T = _traffic(shape)
    t0 = time.perf_counter()
    cands, _ = mapping.enumerate_candidates(shape)
    t_enum = time.perf_counter() - t0
    ctx = mapping._make_scorer_ctx(T, topo, dev)
    edges = mapping._traffic_edges(T, topo, dev)
    mapping.score_device_maps(T, topo, cands, _ctx=ctx)   # warm-up
    _score_looped(T, topo, cands[:1], edges, dev)
    _sync(dev)
    t0 = time.perf_counter()
    batched = mapping.score_device_maps(T, topo, cands, _ctx=ctx)
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    looped = _score_looped(T, topo, cands, edges, dev)
    t_loop = time.perf_counter() - t0
    scale = float(np.abs(looped).max())
    diff = float(np.abs(batched - looped).max())
    if not np.allclose(batched, looped, rtol=1e-3, atol=1e-4 * scale):
        raise AssertionError(f"scorer mismatch on {shape}: {diff} max abs "
                             f"diff")
    return {"mesh": "x".join(str(s) for s in shape),
            "devices": int(np.prod(shape)), "links": int(topo.n_links),
            "candidates": int(cands.shape[0]), "enumerate_s": t_enum,
            "loop_s": t_loop, "batch_s": t_batch,
            "speedup": t_loop / max(t_batch, 1e-9), "max_abs_diff": diff,
            "scale": scale, "best_batched": float(batched.min()),
            "best_looped": float(looped.min())}


def scoring(dev) -> list:
    rows = []
    for shape in SHAPES:
        r = score_row(shape, dev)
        emit("mapping_search", f"mesh_{r['mesh']}", r["batch_s"],
             candidates=r["candidates"], devices=r["devices"],
             loop_s=round(r["loop_s"], 4), batch_s=round(r["batch_s"], 4),
             speedup=round(r["speedup"], 1))
        rows.append(r)
    return rows


def machine_row(name, dev) -> dict:
    """One search (``N_RANDOM`` restarts, timed after a warm-up) on the
    preset ``name`` against the identity map, on the comm makespan and
    on ``capacity_makespan``; raises if the search is worse on either."""
    spec = MachineSpec.preset(name)
    d = spec.n_devices
    T = _traffic(spec.mesh_shape)
    topo = spec.topology()
    kw = dict(machine=spec, n_random=N_RANDOM, device=dev)
    mapping.search(spec.mesh_shape, None, T, **kw)          # warm-up
    t0 = time.perf_counter()
    best = mapping.search(spec.mesh_shape, None, T, **kw)
    t_search = time.perf_counter() - t0
    work = T.sum() / (2 * d)          # mean per-device traffic
    ident = np.arange(d)
    cap_i = mapping.capacity_makespan(T, topo, ident, shard_work=work,
                                      device=dev)
    cap_s = mapping.capacity_makespan(T, topo, best.device_to_bin,
                                      shard_work=work, device=dev)
    m_i = mapping.makespan_of_device_map(T, topo, ident, device=dev)
    if best.bottleneck > m_i or cap_s > cap_i:
        raise AssertionError(
            f"searched > identity on {name}: comm {best.bottleneck} "
            f"vs {m_i}, capacity {cap_s} vs {cap_i}")
    return {"name": name, "devices": d,
            "candidates": int(best.n_candidates), "search_s": t_search,
            "makespan_id": m_i, "makespan_searched": best.bottleneck,
            "ratio": best.bottleneck / max(m_i, 1e-9), "cap_id": cap_i,
            "cap_searched": cap_s,
            "heterogeneous": bool(spec.heterogeneous)}


def machine_sweep(dev) -> list:
    rows = []
    for name in MACHINES:
        r = machine_row(name, dev)
        emit("mapping_search", f"machine_{name}", r["search_s"],
             devices=r["devices"], candidates=r["candidates"],
             makespan_id=round(r["makespan_id"], 1),
             makespan_searched=round(r["makespan_searched"], 1),
             cap_id=round(r["cap_id"], 1),
             cap_searched=round(r["cap_searched"], 1),
             heterogeneous=r["heterogeneous"])
        rows.append(r)
    return rows


def seeded_partition(dev) -> dict:
    """Best-of-S refinement against one seed."""
    from repro_torch.core.partitioner import PartitionConfig, partition
    from repro_torch.graph.generators import rmat
    n, m = tiny((2000, 8000), (300, 1200))
    g = rmat(n, m, seed=0)
    topo = mesh_tree(tiny((2, 16), (2, 4)))
    t0 = time.perf_counter()
    r1 = partition(g, topo, PartitionConfig(seed=0), device=dev)
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    rs = partition(g, topo, PartitionConfig(seed=0, seeds=SEEDS), device=dev)
    t_s = time.perf_counter() - t0
    emit("mapping_search", f"partition_seeds_{SEEDS}", t_s,
         m1=round(r1.makespan, 1), mS=round(rs.makespan, 1),
         one_seed_s=round(t_one, 3), s_seeds_s=round(t_s, 3),
         cost_ratio=round(t_s / max(t_one, 1e-9), 2))
    return {"seeds": SEEDS, "makespan_1": r1.makespan,
            "makespan_S": rs.makespan, "one_seed_s": t_one,
            "s_seeds_s": t_s, "cost_ratio": t_s / max(t_one, 1e-9)}


def run() -> None:
    dev = bench_device()
    out = {"device": str(dev), "scoring": scoring(dev),
           "machines": machine_sweep(dev), "partition_seeds":
           seeded_partition(dev),
           "tiny": os.environ.get("REPRO_BENCH_TINY", "") == "1"}
    with open("BENCH_torch_mapping_search.json", "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote BENCH_torch_mapping_search.json "
          f"(max speedup {max(r['speedup'] for r in out['scoring']):.1f}x, "
          f"{len(out['machines'])} machine presets swept)")


if __name__ == "__main__":
    run()
