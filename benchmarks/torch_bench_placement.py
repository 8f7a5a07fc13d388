"""The framework integrations of the paper's objective on the port: MoE
expert placement (uniform and mixed-generation machines), embedding-table
shard placement, and BSR locality from block placement. Twin of
``bench_placement.py`` over ``repro_torch``: the same four rows on the
same generated inputs, and the same built-in claims (on ``tpu-mixed-32``
the fast pod gets at least the slow pod's expert FLOPs, and the placed
makespan is at most a speed-blind scatter's), which raise on failure.

Each row function takes the partition seed (the reference bench's 0 by
default) and returns the row's numbers unrounded with what it scored,
``scored``: ``(graph, machine, part, scorecard)`` for a host
re-evaluation. Writes ``BENCH_torch_placement.json``. Run from the
repository's root:

    PYTHONPATH=src python -m benchmarks.torch_bench_placement
    REPRO_BENCH_DEVICE=cpu REPRO_BENCH_TINY=1 PYTHONPATH=src \\
        python -m benchmarks.torch_bench_placement
"""
from __future__ import annotations

import json
import os

import numpy as np

from benchmarks.torch_common import bench_device, emit, public, timed, tiny
from repro_torch.core import baselines, mapping
from repro_torch.core.machine import MachineSpec
from repro_torch.core.partitioner import PartitionConfig, partition
from repro_torch.core.topology import balanced_tree, production_tree
from repro_torch.graph.generators import rmat
from repro_torch.graph.graph import from_edges
from repro_torch.kernels.bsr_spmm import bsr_density, to_bsr


def _clustered_traffic(rng, e, per):
    """Symmetric uniform expert-pair traffic with 8 co-activation clusters
    of ``per`` experts (+8 inside each)."""
    traffic = rng.uniform(0, 1, (e, e))
    traffic = traffic + traffic.T
    np.fill_diagonal(traffic, 0)
    for c in range(8):
        idx = np.arange(c * per, (c + 1) * per)
        traffic[np.ix_(idx, idx)] += 8.0
    return traffic


def expert_row(dev, seed: int = 0) -> dict:
    """DeepSeek-V2-scale: 160 experts with clustered co-activation mapped
    onto 2 pods x 8 groups; the bottleneck is the hottest inter-group
    link. Against a hashed scatter of the experts over the devices."""
    rng = np.random.default_rng(0)
    e, per = tiny((160, 20), (32, 4))
    traffic = _clustered_traffic(rng, e, per)
    flops = np.ones(e)
    topo = balanced_tree(tiny((2, 8, 10), (2, 8, 2)),
                         level_cost=(8.0, 1.0, 1.0))
    (part, _), secs = timed(mapping.expert_placement, traffic, flops, topo,
                            seed=seed, device=dev)
    iu = np.triu_indices(e, 1)
    g = from_edges(e, iu[0], iu[1], traffic[iu].astype(np.float32),
                   flops.astype(np.float32))
    scatter = rng.permutation(e) % topo.k
    s_ours = baselines.score_all(g, topo, part, device=dev)
    s_sc = baselines.score_all(g, topo, scatter, device=dev)
    return {"name": f"moe_experts_{e}", "place_s": secs,
            "bottleneck_ours": s_ours["comm_max"],
            "bottleneck_scatter": s_sc["comm_max"],
            "makespan_ours": s_ours["makespan"],
            "makespan_scatter": s_sc["makespan"],
            "win": s_sc["comm_max"] / max(s_ours["comm_max"], 1e-9),
            "scored": [(g, topo, part, s_ours), (g, topo, scatter, s_sc)]}


def hetero_row(dev, seed: int = 0) -> dict:
    """Expert placement on the mixed-generation preset ``tpu-mixed-32``:
    the capacity-normalised objective must put more expert FLOPs on the
    fast pod (bins 0-15) and beat a speed-blind scatter on the normalised
    makespan. Raises when either claim fails."""
    spec = MachineSpec.preset("tpu-mixed-32")
    topo = spec.tree()
    rng = np.random.default_rng(1)
    e = tiny(96, 32)
    traffic = rng.uniform(0, 1, (e, e))
    traffic = traffic + traffic.T
    np.fill_diagonal(traffic, 0)
    flops = rng.uniform(0.5, 2.0, e)
    (part, _), secs = timed(mapping.expert_placement, traffic, flops, topo,
                            seed=seed, device=dev)
    iu = np.triu_indices(e, 1)
    g = from_edges(e, iu[0], iu[1],
                   (traffic[iu] + traffic.T[iu]).astype(np.float32),
                   flops.astype(np.float32))
    scatter = rng.permutation(e) % topo.k
    s_ours = baselines.score_all(g, topo, part, device=dev)
    s_sc = baselines.score_all(g, topo, scatter, device=dev)
    fast = float(flops[np.isin(part, np.arange(16))].sum())
    slow = float(flops.sum()) - fast
    if fast < slow:
        raise AssertionError(f"slow pod got more FLOPs ({slow} > {fast})")
    if s_ours["makespan"] > s_sc["makespan"]:
        raise AssertionError(
            f"placed makespan {s_ours['makespan']} lost to speed-blind "
            f"scatter {s_sc['makespan']}")
    return {"name": f"hetero_experts_{e}", "place_s": secs,
            "makespan_ours": s_ours["makespan"],
            "makespan_scatter": s_sc["makespan"],
            "fast_pod_flops": fast, "slow_pod_flops": slow,
            "scored": [(g, topo, part, s_ours), (g, topo, scatter, s_sc)]}


def table_row(dev, seed: int = 0) -> dict:
    """Embedding rows with Zipf access frequency and co-access edges
    placed over the machine tree; the bottleneck is the hottest device
    during the lookup all-to-all. Against a hashed placement."""
    rng = np.random.default_rng(1)
    rows = tiny(4096, 512)
    freq = np.arange(1, rows + 1) ** -1.1
    freq = (freq / freq.sum() * rows).astype(np.float32)
    g_co = rmat(rows, 6 * rows, seed=2)
    keep = g_co.senders < g_co.receivers
    g = from_edges(rows, g_co.senders[keep], g_co.receivers[keep], None,
                   freq)
    topo = production_tree(2, 4, 4)
    res, secs = timed(partition, g, topo, PartitionConfig(seed=seed),
                      device=dev)
    hashed = rng.permutation(rows) % topo.k
    s_ours = baselines.score_all(g, topo, res.part, device=dev)
    s_hash = baselines.score_all(g, topo, hashed, device=dev)
    return {"name": f"embedding_rows_{rows}", "place_s": secs,
            "hot_device_ours": s_ours["comp_max"],
            "hot_device_hash": s_hash["comp_max"],
            "hot_link_ours": s_ours["comm_max"],
            "hot_link_hash": s_hash["comm_max"],
            "scored": [(g, topo, res.part, s_ours),
                       (g, topo, hashed, s_hash)]}


def bsr_row(dev, seed: int = 0) -> dict:
    """Block placement concentrates the arcs into fewer 128 x 128 BSR
    blocks: the block counts and densities of the graph's layout before
    and after ``block_placement`` of its partition (the host ``to_bsr``,
    as the reference bench calls it; no kernel runs on the layouts)."""
    g = rmat(*tiny((4096, 32768), (1024, 8192)), seed=3)
    topo = balanced_tree((4, 8))
    res, secs = timed(partition, g, topo, PartitionConfig(seed=seed),
                      device=dev)
    pl = mapping.block_placement(res.part, topo.k)
    g2 = mapping.apply_placement(g, pl)
    r0, _, _, nb0 = to_bsr(g.n_nodes, g.senders, g.receivers,
                           g.edge_weight, 128)
    r1, _, _, nb1 = to_bsr(g2.n_nodes, g2.senders, g2.receivers,
                           g2.edge_weight, 128)
    return {"name": f"bsr_locality_{g.n_nodes}", "place_s": secs,
            "block_density_before": bsr_density(r0, nb0, nb0),
            "block_density_after": bsr_density(r1, nb1, nb1),
            "blocks_before": int(r0.shape[0]),
            "blocks_after": int(r1.shape[0]),
            "makespan_ours": float(res.makespan), "scored": []}


ROWS = (expert_row, hetero_row, table_row, bsr_row)
# the numbers each row prints, as the reference bench rounds them
PRINTED = {
    "moe_experts": ("bottleneck_ours", "bottleneck_scatter",
                    "makespan_ours", "makespan_scatter", "win"),
    "hetero_experts": ("makespan_ours", "makespan_scatter",
                       "fast_pod_flops", "slow_pod_flops"),
    "embedding_rows": ("hot_device_ours", "hot_device_hash",
                       "hot_link_ours", "hot_link_hash"),
    "bsr_locality": ("block_density_before", "block_density_after",
                     "blocks_before", "blocks_after"),
}


def placement_rows(dev, seed: int = 0) -> list:
    rows = []
    for fn in ROWS:
        row = fn(dev, seed)
        kind = row["name"].rsplit("_", 1)[0]
        digits = 4 if kind == "bsr_locality" else 1
        emit("placement", row["name"], row["place_s"],
             **{k: (round(row[k], 2 if k == "win" else digits)
                    if isinstance(row[k], float) else row[k])
                for k in PRINTED[kind]})
        rows.append(row)
    return rows


def run() -> None:
    dev = bench_device()
    rows = [public(r) for r in placement_rows(dev)]
    out = {"device": str(dev), "placement": rows,
           "tiny": os.environ.get("REPRO_BENCH_TINY", "") == "1"}
    with open("BENCH_torch_placement.json", "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote BENCH_torch_placement.json ({len(rows)} rows)")


if __name__ == "__main__":
    run()
