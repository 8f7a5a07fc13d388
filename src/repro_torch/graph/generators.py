"""Synthetic graph generators for tests, smoke configs and benchmarks.

Every generator returns a :class:`repro_torch.graph.graph.Graph` and is seeded, so
benchmarks are reproducible without external datasets.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.graph import Graph, from_edges


def grid2d(rows: int, cols: int, seed: int = 0, weighted: bool = False) -> Graph:
    """2D mesh — the canonical high-diameter SpMV-type input (FEM-like)."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    u = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    v = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    if weighted:
        rng = np.random.default_rng(seed)
        w = rng.uniform(0.5, 2.0, size=u.shape[0]).astype(np.float32)
    else:
        w = None
    return from_edges(rows * cols, u, v, w)


def grid3d(nx: int, ny: int, nz: int) -> Graph:
    """3D mesh — models the tetrahedral-mesh workloads of the Lynx code."""
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    us, vs = [], []
    us.append(idx[:-1, :, :].ravel()); vs.append(idx[1:, :, :].ravel())
    us.append(idx[:, :-1, :].ravel()); vs.append(idx[:, 1:, :].ravel())
    us.append(idx[:, :, :-1].ravel()); vs.append(idx[:, :, 1:].ravel())
    return from_edges(nx * ny * nz, np.concatenate(us), np.concatenate(vs))


def rmat(n_nodes: int, n_edges: int, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> Graph:
    """RMAT power-law graph — the low-diameter SpMSpV-type input (social-like)."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n_nodes, 2))))
    u = np.zeros(n_edges, dtype=np.int64)
    v = np.zeros(n_edges, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(n_edges)
        u = 2 * u + ((r >= a + b) & (r < a + b + c)) + (r >= a + b + c)
        v = 2 * v + ((r >= a) & (r < a + b)) + (r >= a + b + c)
    u, v = u % n_nodes, v % n_nodes
    return from_edges(n_nodes, u, v)


def random_regular(n_nodes: int, degree: int, seed: int = 0) -> Graph:
    """Near-regular random graph via the configuration model (collisions dropped)."""
    rng = np.random.default_rng(seed)
    stubs = np.repeat(np.arange(n_nodes), degree)
    rng.shuffle(stubs)
    half = stubs.shape[0] // 2
    return from_edges(n_nodes, stubs[:half], stubs[half:2 * half])


def molecule_batch(n_graphs: int, nodes_per_graph: int, edges_per_graph: int,
                   seed: int = 0) -> Graph:
    """Disjoint union of small random molecules (batched-small-graph regime)."""
    rng = np.random.default_rng(seed)
    us, vs = [], []
    for i in range(n_graphs):
        base = i * nodes_per_graph
        # random connected-ish: a path + random chords
        path = np.arange(nodes_per_graph - 1)
        extra = rng.integers(0, nodes_per_graph,
                             size=(max(edges_per_graph - nodes_per_graph + 1, 0), 2))
        us.append(base + np.concatenate([path, extra[:, 0]]))
        vs.append(base + np.concatenate([path + 1, extra[:, 1]]))
    return from_edges(n_graphs * nodes_per_graph, np.concatenate(us), np.concatenate(vs))


def weighted_nodes(g: Graph, seed: int = 0, lo: float = 0.5, hi: float = 2.0) -> Graph:
    rng = np.random.default_rng(seed)
    nw = rng.uniform(lo, hi, size=g.n_nodes).astype(np.float32)
    return Graph(g.n_nodes, g.senders, g.receivers, g.edge_weight, nw, g.offsets)
