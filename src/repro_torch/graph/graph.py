"""Application-graph substrate (numpy; twin of ``repro/graph/graph.py``).

Graphs are stored as symmetric arc lists (every undirected edge {u, v} appears
as both u->v and v->u with the same weight). This is the layout every consumer
wants: ``index_add_`` message passing, the quotient-matrix objective, and the
CUDA scatter/gather kernels all operate on arc lists, and CSR offsets are
derived once on the host. The port keeps its own copy so that it never
imports the JAX package; arrays are identical for the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Symmetric arc-list graph with CSR offsets.

    Invariants:
      * ``senders``/``receivers`` contain both directions of every undirected
        edge; ``edge_weight[a]`` is the weight of the undirected edge, repeated
        on both arcs.
      * arcs are sorted by ``senders`` (CSR order); ``offsets[v]:offsets[v+1]``
        is the neighbor slice of ``v``.
    """

    n_nodes: int
    senders: np.ndarray      # [m] int32, CSR-sorted
    receivers: np.ndarray    # [m] int32
    edge_weight: np.ndarray  # [m] float32
    node_weight: np.ndarray  # [n] float32
    offsets: np.ndarray      # [n + 1] int64

    @property
    def n_arcs(self) -> int:
        return int(self.senders.shape[0])

    @property
    def n_edges(self) -> int:
        return self.n_arcs // 2

    def degrees(self) -> np.ndarray:
        return np.diff(self.offsets)

    def total_node_weight(self) -> float:
        return float(self.node_weight.sum())


def _csr_sort(n: int, s: np.ndarray, r: np.ndarray, w: np.ndarray):
    order = np.argsort(s, kind="stable")
    s, r, w = s[order], r[order], w[order]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.add.at(offsets, s + 1, 1)
    offsets = np.cumsum(offsets)
    return s, r, w, offsets


def from_edges(
    n_nodes: int,
    u: np.ndarray,
    v: np.ndarray,
    edge_weight: Optional[np.ndarray] = None,
    node_weight: Optional[np.ndarray] = None,
    dedup: bool = True,
) -> Graph:
    """Build a :class:`Graph` from an undirected edge list (one arc per edge).

    Self-loops are dropped; parallel edges are merged (weights added) when
    ``dedup`` is set.
    """
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    if edge_weight is None:
        edge_weight = np.ones(u.shape[0], dtype=np.float32)
    edge_weight = np.asarray(edge_weight, dtype=np.float32)
    keep = u != v
    u, v, edge_weight = u[keep], v[keep], edge_weight[keep]
    if dedup and u.size:
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        key = lo * n_nodes + hi
        uniq, inv = np.unique(key, return_inverse=True)
        w = np.zeros(uniq.shape[0], dtype=np.float32)
        np.add.at(w, inv, edge_weight)
        u, v, edge_weight = uniq // n_nodes, uniq % n_nodes, w
    s = np.concatenate([u, v]).astype(np.int32)
    r = np.concatenate([v, u]).astype(np.int32)
    w2 = np.concatenate([edge_weight, edge_weight]).astype(np.float32)
    s, r, w2, offsets = _csr_sort(n_nodes, s, r, w2)
    if node_weight is None:
        node_weight = np.ones(n_nodes, dtype=np.float32)
    return Graph(
        n_nodes=n_nodes,
        senders=s,
        receivers=r.astype(np.int32),
        edge_weight=w2,
        node_weight=np.asarray(node_weight, dtype=np.float32),
        offsets=offsets,
    )


def permute(g: Graph, perm: np.ndarray) -> Graph:
    """Relabel nodes: new id of old node v is ``perm[v]``."""
    perm = np.asarray(perm, dtype=np.int64)
    inv_w = np.empty(g.n_nodes, dtype=np.float32)
    inv_w[perm] = g.node_weight
    s = perm[g.senders].astype(np.int32)
    r = perm[g.receivers].astype(np.int32)
    s2, r2, w2, offsets = _csr_sort(g.n_nodes, s, r, g.edge_weight.copy())
    return Graph(g.n_nodes, s2, r2.astype(np.int32), w2, inv_w, offsets)


def subgraph(g: Graph, nodes: np.ndarray) -> Graph:
    """Induced subgraph on ``nodes`` (relabeled 0..len(nodes)-1)."""
    nodes = np.asarray(nodes, dtype=np.int64)
    mask = np.zeros(g.n_nodes, dtype=bool)
    mask[nodes] = True
    new_id = np.full(g.n_nodes, -1, dtype=np.int64)
    new_id[nodes] = np.arange(nodes.shape[0])
    keep = mask[g.senders] & mask[g.receivers] & (g.senders < g.receivers)
    return from_edges(
        nodes.shape[0],
        new_id[g.senders[keep]],
        new_id[g.receivers[keep]],
        g.edge_weight[keep],
        g.node_weight[nodes],
        dedup=False,
    )
