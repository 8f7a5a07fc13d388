"""The paper's section 3.1 generalisations on the port, end to end:
routers, per-link F_l (a fat tree), the routing oracle with single and
multiple paths (a torus), vertex weights and per-bin speeds. Twin of
``bench_variants.py`` over ``repro_torch``; its rows land in
``BENCH_torch_variants.json`` in the working directory. Run from the
repository's root:

    PYTHONPATH=src python -m benchmarks.torch_bench_variants
    REPRO_BENCH_DEVICE=cpu REPRO_BENCH_TINY=1 PYTHONPATH=src \\
        python -m benchmarks.torch_bench_variants

The torus rows score the bench's random part (``default_rng(0)``) through
the host oracle ``makespan_routing_ref``: the same numpy draw and the same
walk as the reference, so they equal its rows.
"""
from __future__ import annotations

import json
from typing import List

import numpy as np

from benchmarks.torch_common import TINY, bench_device, emit, timed, tiny
from repro_torch.core import baselines, reference
from repro_torch.core.partitioner import PartitionConfig, partition
from repro_torch.core.topology import (balanced_tree, fat_tree_topology,
                                       make_tree, torus2d_topology,
                                       with_bin_speed)
from repro_torch.graph.generators import grid2d, rmat, weighted_nodes

GRID = tiny((32, 32), (16, 16))
TORUS_RMAT = tiny((2000, 9000), (500, 2000))
WEIGHTED_RMAT = tiny((3000, 15000), (800, 4000))


def _scored(g, topo, res):
    """A partition result as ``(graph, machine, part, scorecard)``."""
    return (g, topo, res.part, {"makespan": res.makespan,
                                "comp_max": res.comp_max,
                                "comm_max": res.comm_max})


def torus_rows() -> List[dict]:
    """The torus rows: the bench's random part scored by the routing
    oracle on the host, single path and multipath."""
    g2 = rmat(*TORUS_RMAT, seed=4)
    rng = np.random.default_rng(0)
    rows = []
    for mp in (False, True):
        topo_t = torus2d_topology(4, 4, multipath=mp)
        part = rng.integers(0, topo_t.k, g2.n_nodes)
        m, _, comm = reference.makespan_routing_ref(part, g2, topo_t)
        rows.append(dict(name=f"torus_multipath={mp}", seconds=0.0,
                         makespan=float(m), max_link=float(comm.max()),
                         total_link=float(comm.sum())))
    return rows


def variants_rows(device, seed: int = 0) -> List[dict]:
    """Every row of the bench, each partition seeded with ``seed``: its
    name, numbers and seconds, and for the partitioned rows what was
    scored, ``scored``: ``(graph, machine, part, scorecard)``."""
    cfg = PartitionConfig(seed=seed)
    rows = []
    g = grid2d(*GRID)

    # routers: a star of stars with a router interior
    parent = [-1] + [0] * 4 + [1 + i // 4 for i in range(16)]
    topo_r = make_tree(parent)
    res, secs = timed(partition, g, topo_r, cfg, device=device)
    rows.append(dict(name="routers_16bins", seconds=secs,
                     makespan=res.makespan,
                     n_routers=int(topo_r.is_router.sum()),
                     scored=[_scored(g, topo_r, res)]))

    # fat tree: F_l decreasing toward the root
    topo_f = fat_tree_topology(16, arity=4, uplink_speedup=2.0)
    res_f, secs = timed(partition, g, topo_f, cfg, device=device)
    cut = baselines.total_cut_partition(
        g, topo_f.k, baselines.CutRefineConfig(seed=seed), device=device)
    s_cut = baselines.score_all(g, topo_f, cut, device=device)
    rows.append(dict(name="fat_tree_Fl", seconds=secs,
                     makespan=res_f.makespan,
                     makespan_cut_baseline=s_cut["makespan"],
                     scored=[_scored(g, topo_f, res_f),
                             (g, topo_f, cut, s_cut)]))

    rows += torus_rows()

    # vertex weights
    gw = weighted_nodes(rmat(*WEIGHTED_RMAT, seed=5), seed=5, lo=0.1, hi=8.0)
    topo_w = balanced_tree((4, 4))
    res_w, secs = timed(partition, gw, topo_w, cfg, device=device)
    rows.append(dict(name="vertex_weighted", seconds=secs,
                     makespan=res_w.makespan,
                     perfect_balance=float(gw.node_weight.sum() / topo_w.k),
                     comp_max=res_w.comp_max,
                     scored=[_scored(gw, topo_w, res_w)]))

    # heterogeneous PEs: half-speed second half; the capacity-normalised
    # partitioner shifts raw load onto the fast bins
    topo_h = with_bin_speed(topo_w, [1.0] * 8 + [0.5] * 8)
    res_h, secs = timed(partition, gw, topo_h, cfg, device=device)
    raw = np.zeros(topo_h.k)
    np.add.at(raw, res_h.part, gw.node_weight)
    rows.append(dict(name="hetero_speeds", seconds=secs,
                     makespan=res_h.makespan,
                     fast_load=float(raw[:8].sum()),
                     slow_load=float(raw[8:].sum()),
                     scored=[_scored(gw, topo_h, res_h)]))
    return rows


NUMBERS = ("makespan", "makespan_cut_baseline", "n_routers", "max_link",
           "total_link", "perfect_balance", "comp_max", "fast_load",
           "slow_load")


def run() -> None:
    dev = bench_device()
    out = []
    for row in variants_rows(dev):
        nums = {k: (round(row[k], 1) if isinstance(row[k], float)
                    else row[k]) for k in NUMBERS if k in row}
        emit("variants", row["name"], row["seconds"], **nums)
        out.append({"name": row["name"],
                    "partition_s": round(row["seconds"], 4), **nums})
    with open("BENCH_torch_variants.json", "w") as f:
        json.dump({"variants": out, "tiny": TINY, "device": str(dev)}, f,
                  indent=1)
    print(f"wrote BENCH_torch_variants.json ({len(out)} rows)")


if __name__ == "__main__":
    run()
