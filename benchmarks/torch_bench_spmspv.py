"""C2 on the port, the SpMSpV regime (frontier computations): on
low-diameter graphs a few high-volume rounds, where the bottleneck
objective helps; on high-diameter graphs many small rounds, where the
advantage dissolves (paper section 1). Twin of ``bench_spmspv.py`` over
``repro_torch``.

BFS from random sources; per round, each active arc (one leaving the
frontier) whose endpoints sit in different bins sends one unit along its
tree path. A round costs its most loaded link (times ``F_l``), a source
the sum over its rounds. :func:`bfs_round_cost` walks the paths on the
host, as the reference does; the twin's own path, :func:`card_round_costs`,
sends each round's active arc list to the card and takes the round's link
loads from the ``quotient_link_loads`` kernel (``ops.link_loads``). Run
from the repository's root:

    PYTHONPATH=src python -m benchmarks.torch_bench_spmspv
    REPRO_BENCH_DEVICE=cpu REPRO_BENCH_TINY=1 PYTHONPATH=src \\
        python -m benchmarks.torch_bench_spmspv
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

from benchmarks.torch_common import bench_device, emit, tiny
from repro_torch import resolve_device
from repro_torch.core import baselines, reference
from repro_torch.core.partitioner import PartitionConfig, partition
from repro_torch.core.topology import balanced_tree
from repro_torch.graph.generators import grid2d, rmat
from repro_torch.graph.graph import Graph
from repro_torch.kernels import ops

_SIDE = tiny(64, 24)
_RN, _RM = tiny((4000, 24000), (800, 4800))
CASES = [("low_diam_rmat", lambda: rmat(_RN, _RM, seed=3)),
         ("high_diam_grid", lambda: grid2d(_SIDE, _SIDE))]


def machine():
    return balanced_tree((2, 4), level_cost=(6.0, 1.0))


def bfs_rounds(g: Graph, source: int) -> Iterator[Tuple[np.ndarray,
                                                        np.ndarray]]:
    """Each BFS round's active arcs from ``source`` (those leaving the
    frontier), as ``(senders, receivers)``: the reference's walk, which
    marks every newly reached vertex and expands each once."""
    dist = np.full(g.n_nodes, -1, np.int64)
    dist[source] = 0
    frontier = np.asarray([source])
    while frontier.size:
        arcs = np.concatenate([np.arange(s, e) for s, e in
                               zip(g.offsets[frontier],
                                   g.offsets[frontier + 1])])
        dsts = g.receivers[arcs]
        yield g.senders[arcs], dsts
        new = dsts[dist[dsts] < 0]
        dist[new] = 1
        frontier = np.unique(new)


def host_round_costs(g: Graph, topo, part, source: int) -> List[float]:
    """Each round's bottleneck-link traffic, walking every crossing arc's
    tree path on the host (``reference.tree_path_links``)."""
    costs, link_of_pair = [], {}
    for srcs, dsts in bfs_rounds(g, source):
        load = np.zeros(topo.n_links)
        cross = part[srcs] != part[dsts]
        for s, d in zip(srcs[cross], dsts[cross]):
            key = (int(part[s]), int(part[d]))
            if key not in link_of_pair:
                link_of_pair[key] = reference.tree_path_links(
                    topo, key[0], key[1])
            for link in link_of_pair[key]:
                load[link] += 1
        costs.append((topo.F_l * load).max() if load.size else 0.0)
    return costs


def bfs_round_cost(g: Graph, topo, part, source: int) -> float:
    """Sum over BFS rounds of the bottleneck-link traffic of that round
    (the reference's host walk)."""
    total = 0.0
    for c in host_round_costs(g, topo, part, source):
        total += c
    return total


def card_round_costs(g: Graph, topo, part, source: int,
                     device) -> List[float]:
    """Each round's cost from the ``quotient_link_loads`` kernel on
    ``device``: the round's active arcs with unit weights. The kernel gives
    ``F_l * 0.5 (S r + S c - 2 diag)``, half a unit per directed crossing,
    so the round's cost is twice its largest entry; with unit weights every
    value is an integer, exact in float32."""
    dev = resolve_device(device)
    p = torch.as_tensor(np.array(part, dtype=np.int32), device=dev)
    sub = torch.as_tensor(topo.subtree, dtype=torch.float32, device=dev)
    fl = torch.as_tensor(topo.F_l, dtype=torch.float32, device=dev)
    costs = []
    for srcs, dsts in bfs_rounds(g, source):
        if srcs.size == 0:
            costs.append(0.0)
            continue
        s = torch.as_tensor(srcs, dtype=torch.int32, device=dev)
        d = torch.as_tensor(dsts, dtype=torch.int32, device=dev)
        loads = ops.link_loads(p, s, d, torch.ones(s.shape[0], device=dev),
                               sub, fl, topo.k)
        costs.append(2.0 * float(loads.max()))
    return costs


def spmspv_row(g: Graph, topo, device, seed: int = 0,
               host_walk: bool = False) -> dict:
    """One case: the makespan and total-cut partitions (seeded with
    ``seed``), each one's frontier cost averaged over the bench's three
    sources (``default_rng(0)``) through the card, and the cut's over ours.
    ``host_walk`` also walks every round on the host (``host_rounds``) for
    a round-by-round check against ``card_rounds``."""
    parts = {"ours": partition(g, topo, PartitionConfig(seed=seed),
                               device=device).part,
             "cut": baselines.total_cut_partition(
                 g, topo.k, baselines.CutRefineConfig(seed=seed),
                 device=device)}
    srcs = np.random.default_rng(0).integers(0, g.n_nodes, 3)
    row = {"parts": parts, "card_rounds": {}, "host_rounds": {}}
    for method, part in parts.items():
        rounds = [card_round_costs(g, topo, part, int(s), device)
                  for s in srcs]
        row["card_rounds"][method] = rounds
        if host_walk:
            row["host_rounds"][method] = [
                host_round_costs(g, topo, part, int(s)) for s in srcs]
        total = []
        for r in rounds:
            t = 0.0
            for c in r:
                t += c
            total.append(t)
        row[f"frontier_cost_{method}"] = float(np.mean(total))
    row["ratio"] = row["frontier_cost_cut"] / max(row["frontier_cost_ours"],
                                                  1e-9)
    return row


def run() -> None:
    dev = bench_device()
    topo = machine()
    for name, mk_g in CASES:
        row = spmspv_row(mk_g(), topo, dev)
        emit("C2_spmspv", name, 0.0,
             frontier_cost_ours=round(row["frontier_cost_ours"], 1),
             frontier_cost_cut=round(row["frontier_cost_cut"], 1),
             ratio=round(row["ratio"], 3))


if __name__ == "__main__":
    run()
