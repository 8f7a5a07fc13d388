"""The JAX reference's rows of ``benchmarks/bench_placement.py`` over
partition seeds: the bands the port's ``placement`` phase
(``chip_smoke.py``) is held to.

The twin of ``scripts/c1_reference_rows.py`` for the placement bench at
its full tier. Each row is computed as the bench computes it, with
``seed`` in place of the bench's 0 for the partitioner's seed
(``PartitionConfig.seed``, ``expert_placement(seed=)``); the traffic, the
FLOPs and the scatter and hash baselines stay the bench's own
``default_rng`` draws, so every seed scores the same inputs. Numbers are
unrounded. One JSON line per seed. Run on a CPU:

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/placement_reference_rows.py \\
        [--seeds 0,1,2,3]
    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/placement_reference_rows.py \\
        --bands rows.jsonl

``--bands`` reads such lines back (files of them, or ``-`` for standard
input) and prints the placement entries of ``chip_smoke.py``'s
``CLAIMS_REF``, keyed ``("placement", row, number)``: the least and
largest of each number of ``CHECKED`` over the lines' seeds (floored and
ceiled at 4 decimals); and of its ``CLAIMS_EXACT``: each number of
``EXACT``, which no partition seed moves, unrounded (it raises where two
seeds differ).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

from repro.core import baselines, mapping
from repro.core.machine import MachineSpec
from repro.core.partitioner import PartitionConfig, partition
from repro.core.topology import balanced_tree, production_tree
from repro.graph.generators import rmat
from repro.graph.graph import from_edges
from repro.kernels.bsr_spmm import bsr_density, to_bsr

# the numbers the port's rows are held to within the seeds' band, by row
CHECKED = {
    "moe_experts_160": ("bottleneck_ours", "makespan_ours"),
    "hetero_experts_96": ("makespan_ours",),
    "embedding_rows_4096": ("hot_device_ours", "hot_link_ours"),
    "bsr_locality_4096": ("block_density_after", "blocks_after"),
}
# the numbers no partition seed moves, held to the reference's value: the
# scatter and hash baselines score the bench's own draws, blocks_before
# the unplaced graph, and every seed puts all the experts' FLOPs on the
# fast pod
EXACT = {
    "moe_experts_160": ("bottleneck_scatter", "makespan_scatter"),
    "hetero_experts_96": ("makespan_scatter", "fast_pod_flops",
                          "slow_pod_flops"),
    "embedding_rows_4096": ("hot_device_hash", "hot_link_hash"),
    "bsr_locality_4096": ("blocks_before", "block_density_before"),
}


def expert(seed: int) -> dict:
    rng = np.random.default_rng(0)
    e, per = 160, 20
    traffic = rng.uniform(0, 1, (e, e))
    traffic = traffic + traffic.T
    np.fill_diagonal(traffic, 0)
    for c in range(8):
        idx = np.arange(c * per, (c + 1) * per)
        traffic[np.ix_(idx, idx)] += 8.0
    flops = np.ones(e)
    topo = balanced_tree((2, 8, 10), level_cost=(8.0, 1.0, 1.0))
    part, _ = mapping.expert_placement(traffic, flops, topo, seed=seed)
    iu = np.triu_indices(e, 1)
    g = from_edges(e, iu[0], iu[1], traffic[iu].astype(np.float32),
                   flops.astype(np.float32))
    scatter = rng.permutation(e) % topo.k
    s_ours = baselines.score_all(g, topo, part)
    s_sc = baselines.score_all(g, topo, scatter)
    return {"bottleneck_ours": s_ours["comm_max"],
            "bottleneck_scatter": s_sc["comm_max"],
            "makespan_ours": s_ours["makespan"],
            "makespan_scatter": s_sc["makespan"]}


def hetero(seed: int) -> dict:
    topo = MachineSpec.preset("tpu-mixed-32").tree()
    rng = np.random.default_rng(1)
    e = 96
    traffic = rng.uniform(0, 1, (e, e))
    traffic = traffic + traffic.T
    np.fill_diagonal(traffic, 0)
    flops = rng.uniform(0.5, 2.0, e)
    part, _ = mapping.expert_placement(traffic, flops, topo, seed=seed)
    iu = np.triu_indices(e, 1)
    g = from_edges(e, iu[0], iu[1],
                   (traffic[iu] + traffic.T[iu]).astype(np.float32),
                   flops.astype(np.float32))
    scatter = rng.permutation(e) % topo.k
    s_ours = baselines.score_all(g, topo, part)
    s_sc = baselines.score_all(g, topo, scatter)
    fast = float(flops[np.isin(part, np.arange(16))].sum())
    return {"makespan_ours": s_ours["makespan"],
            "makespan_scatter": s_sc["makespan"], "fast_pod_flops": fast,
            "slow_pod_flops": float(flops.sum()) - fast}


def table(seed: int) -> dict:
    rng = np.random.default_rng(1)
    rows = 4096
    freq = np.arange(1, rows + 1) ** -1.1
    freq = (freq / freq.sum() * rows).astype(np.float32)
    g_co = rmat(rows, 6 * rows, seed=2)
    keep = g_co.senders < g_co.receivers
    g = from_edges(rows, g_co.senders[keep], g_co.receivers[keep], None,
                   freq)
    topo = production_tree(2, 4, 4)
    res = partition(g, topo, PartitionConfig(seed=seed))
    hashed = rng.permutation(rows) % topo.k
    s_ours = baselines.score_all(g, topo, res.part)
    s_hash = baselines.score_all(g, topo, hashed)
    return {"hot_device_ours": s_ours["comp_max"],
            "hot_device_hash": s_hash["comp_max"],
            "hot_link_ours": s_ours["comm_max"],
            "hot_link_hash": s_hash["comm_max"]}


def bsr(seed: int) -> dict:
    g = rmat(4096, 32768, seed=3)
    topo = balanced_tree((4, 8))
    res = partition(g, topo, PartitionConfig(seed=seed))
    pl = mapping.block_placement(res.part, topo.k)
    g2 = mapping.apply_placement(g, pl)
    r0, _, _, nb0 = to_bsr(g.n_nodes, g.senders, g.receivers,
                           g.edge_weight, 128)
    r1, _, _, nb1 = to_bsr(g2.n_nodes, g2.senders, g2.receivers,
                           g2.edge_weight, 128)
    return {"block_density_before": bsr_density(r0, nb0, nb0),
            "block_density_after": bsr_density(r1, nb1, nb1),
            "blocks_before": int(r0.shape[0]),
            "blocks_after": int(r1.shape[0])}


ROWS = {"moe_experts_160": expert, "hetero_experts_96": hetero,
        "embedding_rows_4096": table, "bsr_locality_4096": bsr}


def bands(lines) -> str:
    """The ``CLAIMS_REF`` and ``CLAIMS_EXACT`` entries from row lines."""
    ref, exact = {}, {}
    for ln in lines:
        d = json.loads(ln)
        for row, vals in d["rows"].items():
            for key in CHECKED[row]:
                lo, hi = ref.get((row, key), (math.inf, -math.inf))
                ref[(row, key)] = (min(lo, vals[key]), max(hi, vals[key]))
            for key in EXACT[row]:
                if exact.setdefault((row, key), vals[key]) != vals[key]:
                    raise ValueError(f"{row} {key}: {vals[key]} at seed "
                                     f"{d['seed']}, {exact[(row, key)]} "
                                     f"before")
    out = ["CLAIMS_REF.update({"]
    for (r, k), (lo, hi) in sorted(ref.items()):
        out.append(f"    ('placement', {r!r}, {k!r}): "
                   f"({math.floor(lo * 1e4) / 1e4!r}, "
                   f"{math.ceil(hi * 1e4) / 1e4!r}),")
    out.append("})")
    out.append("CLAIMS_EXACT.update({")
    for (r, k), v in sorted(exact.items()):
        out.append(f"    ('placement', {r!r}, {k!r}): {v!r},")
    out.append("})")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--bands", nargs="*", default=None, metavar="FILE")
    args = ap.parse_args()
    if args.bands is not None:
        lines = []
        for path in args.bands or ["-"]:
            f = sys.stdin if path == "-" else open(path)
            lines += [ln for ln in f if ln.strip()]
        print(bands(lines))
        return
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rows = {name: fn(seed) for name, fn in ROWS.items()}
        print(json.dumps({"seed": seed, "rows": rows,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
