"""Pure-Python/numpy oracle for the paper's objective.

Walks actual tree paths per edge — O(m * depth). Slow and obviously correct;
the torch quotient-matrix implementation in ``objective.py`` (and the
``quotient_link_loads`` kernel under it) is validated against this, and
``partitioner.verify`` cross-checks every result with it. Copied unchanged
from ``repro/core/reference.py``.
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.topology import RoutingTopology, TreeTopology
from repro_torch.graph.graph import Graph


def tree_path_links(topo: TreeTopology, a_bin: int, b_bin: int) -> list:
    """Link ids (index into topo.link_nodes) on the unique path between
    compute bins a and b (bin index space)."""
    a = int(topo.compute_bins[a_bin])
    b = int(topo.compute_bins[b_bin])
    # climb to root recording nodes
    def chain(x):
        out = [x]
        while topo.parent[x] >= 0:
            x = int(topo.parent[x])
            out.append(x)
        return out
    ca, cb = chain(a), chain(b)
    sa, sb = set(ca), set(cb)
    lca = next(x for x in ca if x in sb)
    nodes = ca[: ca.index(lca)] + cb[: cb.index(lca)]
    link_of = {int(c): i for i, c in enumerate(topo.link_nodes)}
    return [link_of[x] for x in nodes]


def makespan_ref(part: np.ndarray, g: Graph, topo: TreeTopology,
                 speed: Optional[np.ndarray] = None
                 ) -> Tuple[float, np.ndarray, np.ndarray]:
    """(makespan, comp[k], comm[L]) by explicit path walking.

    ``speed`` (or ``topo.bin_speed`` when unset) normalizes bin loads to
    ``comp(b)/speed(b)`` — the heterogeneous-PE objective; the returned
    ``comp`` is then the normalized load, matching
    ``objective.makespan_tree``'s breakdown. ``speed=None`` on a speed-free
    topology is the exact uniform path (no division anywhere)."""
    part = np.asarray(part)
    if speed is None:
        speed = topo.bin_speed
    comp = np.zeros(topo.k)
    np.add.at(comp, part, g.node_weight)
    if speed is not None:
        comp = comp / np.asarray(speed, dtype=comp.dtype)
    comm = np.zeros(topo.n_links)
    seen = g.senders < g.receivers
    for u, v, w in zip(g.senders[seen], g.receivers[seen], g.edge_weight[seen]):
        bu, bv = int(part[u]), int(part[v])
        if bu == bv:
            continue
        for l in tree_path_links(topo, bu, bv):
            comm[l] += w
    comm_cost = topo.F_l * comm
    m = max(comp.max(), comm_cost.max() if comm.size else 0.0)
    return float(m), comp, comm


def makespan_routing_ref(part: np.ndarray, g: Graph,
                         topo: RoutingTopology) -> Tuple[float, np.ndarray, np.ndarray]:
    part = np.asarray(part)
    comp = np.zeros(topo.k)
    np.add.at(comp, part, g.node_weight)
    comm = np.zeros(topo.n_links)
    seen = g.senders < g.receivers
    for u, v, w in zip(g.senders[seen], g.receivers[seen], g.edge_weight[seen]):
        bu, bv = int(part[u]), int(part[v])
        if bu == bv:
            continue
        comm += w * topo.path_incidence[bu, bv]
    m = max(comp.max(), (topo.F_l * comm).max() if comm.size else 0.0)
    return float(m), comp, comm


def total_cut_ref(part: np.ndarray, g: Graph) -> float:
    seen = g.senders < g.receivers
    cut = part[g.senders[seen]] != part[g.receivers[seen]]
    return float(g.edge_weight[seen][cut].sum())


def brute_force_optimum(g: Graph, topo: TreeTopology,
                        max_states: int = 2_000_000) -> Tuple[float, np.ndarray]:
    """Exact optimum by enumeration (small instances only)."""
    k, n = topo.k, g.n_nodes
    if k ** n > max_states:
        raise ValueError(f"{k}^{n} assignments > {max_states}")
    best, best_p = np.inf, None
    for assign in itertools.product(range(k), repeat=n):
        p = np.asarray(assign, dtype=np.int32)
        m, _, _ = makespan_ref(p, g, topo)
        if m < best:
            best, best_p = m, p
    return best, best_p
