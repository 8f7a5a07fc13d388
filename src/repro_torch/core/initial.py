"""Initial partitioning on the coarsest graph: hierarchical greedy growing.

Splits the vertex set top-down along the machine tree — at each internal node
the current set is divided among the children proportionally to the compute
capacity (number of leaves) beneath each child, by greedy region growing
(max-connectivity frontier). Host-side; the coarsest graph is small
(~coarse_factor * k vertices).

This is the direct tree-aware construction the paper calls for (its related
work had to emulate hierarchy by "applying conventional partitioning twice").
``initial_partition_device`` is the device V-cycle's parallel counterpart:
a capacity-proportional prefix split over the coarsest graph (one
``prefix_split`` CUDA kernel call instead of the sequential greedy grow).
Twin of ``repro/core/initial.py``; the host paths are numpy copies, exact
for the same seed.
"""
from __future__ import annotations

import heapq
from typing import List

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.topology import TreeTopology
from repro_torch.graph.graph import Graph
from repro_torch.kernels import ops


class _Unreached:
    """The vertices of ``avail & ~region`` in index order, shrinking as the
    region grows. The reference rescans all n vertices at every restart
    of a disconnected region (O(n) each, O(n^2) on a graph of many
    isolated vertices such as a sparsely sampled embedding table); here
    per-block counts find the r-th vertex in O(n / B + B)."""
    B = 1024

    def __init__(self, avail: np.ndarray):
        self.free = avail.copy()
        pad = np.zeros(-(-avail.size // self.B) * self.B, dtype=bool)
        pad[:avail.size] = avail
        self.count = pad.reshape(-1, self.B).sum(1)
        self.size = int(self.count.sum())

    def take(self, v: int) -> None:
        self.free[v] = False
        self.count[v // self.B] -= 1
        self.size -= 1

    def nth(self, r: int) -> int:
        cum = np.cumsum(self.count)
        blk = int(np.searchsorted(cum, r, side="right"))
        lo = blk * self.B
        inside = np.nonzero(self.free[lo:lo + self.B])[0]
        return lo + int(inside[r - int(cum[blk] - self.count[blk])])


def _greedy_grow(g: Graph, avail: np.ndarray, target_w: float,
                 rng: np.random.Generator) -> np.ndarray:
    """Grow one region of ~target_w node weight inside ``avail`` (bool mask).
    Returns bool mask of the region. Frontier keyed by -connectivity."""
    region = np.zeros(g.n_nodes, dtype=bool)
    conn = np.zeros(g.n_nodes, dtype=np.float64)
    cand = np.nonzero(avail)[0]
    if cand.size == 0:
        return region
    degs = g.offsets[cand + 1] - g.offsets[cand]
    seed = int(cand[int(np.argmax(degs + rng.random(cand.size)))])
    heap = [(-0.0, seed)]
    unreached = _Unreached(avail)
    got = 0.0
    while heap and got < target_w:
        negc, v = heapq.heappop(heap)
        if region[v] or not avail[v]:
            continue
        if -negc < conn[v]:  # stale entry
            heapq.heappush(heap, (-conn[v], v))
            continue
        region[v] = True
        unreached.take(v)
        got += float(g.node_weight[v])
        lo, hi = g.offsets[v], g.offsets[v + 1]
        for u, w in zip(g.receivers[lo:hi], g.edge_weight[lo:hi]):
            u = int(u)
            if avail[u] and not region[u]:
                conn[u] += float(w)
                heapq.heappush(heap, (-conn[u], u))
        if not heap:  # disconnected: restart from a new seed
            if unreached.size and got < target_w:
                s2 = unreached.nth(int(rng.integers(unreached.size)))
                heapq.heappush(heap, (-0.0, s2))
    return region


def initial_partition(g: Graph, topo: TreeTopology, seed: int = 0) -> np.ndarray:
    """part[v] in [0, topo.k): compute-bin assignment by recursive splitting.

    Split targets are proportional to the compute *capacity* beneath each
    child — the leaf count on uniform machines, the summed ``bin_speed``
    on heterogeneous ones (``core.machine``), so a pod of slow chips
    starts with proportionally fewer vertices."""
    rng = np.random.default_rng(seed)
    part = np.zeros(g.n_nodes, dtype=np.int32)
    root = int(np.nonzero(topo.parent < 0)[0][0])
    speed = topo.bin_speed
    if speed is not None and not (np.asarray(speed) > 0).all():
        # degraded machines must mask dead leaves out of compute_bins
        # (MachineSpec.degrade / topology.mask_bins), never zero a speed:
        # a zero-capacity bin would absorb vertices it can never execute
        raise ValueError("zero-capacity bin reached the partitioner — "
                         "mask dead leaves instead of zeroing bin_speed")

    def cap_of(bins: np.ndarray) -> float:
        return float(bins.size if speed is None else speed[bins].sum())

    def recurse(node: int, mask: np.ndarray) -> None:
        kids = topo.children(node)
        kid_bins: List[np.ndarray] = [topo.leaves_under(int(c)) for c in kids]
        live = [(int(c), b) for c, b in zip(kids, kid_bins) if b.size > 0]
        if not live:
            # leaf compute bin (or router leaf — routers have no bins under
            # them and never get vertices)
            bins_here = topo.leaves_under(node)
            if bins_here.size:
                part[mask] = int(bins_here[0])
            return
        if len(live) == 1:
            recurse(live[0][0], mask)
            return
        total_cap = sum(cap_of(b) for _, b in live)
        total_w = float(g.node_weight[mask].sum())
        avail = mask.copy()
        for child, bins in live[:-1]:
            target = total_w * cap_of(bins) / total_cap
            region = _greedy_grow(g, avail, target, rng)
            recurse(child, region)
            avail &= ~region
        recurse(live[-1][0], avail)

    recurse(root, np.ones(g.n_nodes, dtype=bool))
    return part


def initial_partition_device(g: Graph, topo: TreeTopology, seed: int = 0, *,
                             device: DeviceLike = None) -> np.ndarray:
    """Device-path initial assignment: capacity-proportional prefix split.

    Vertex ``v``'s weight midpoint ``cum[v] = prefix_sum(w)[v] - w[v]/2`` is
    bucketed against the k-1 interior capacity prefix targets, so bin ``b``
    receives a contiguous vertex run of ~``capacity(b)/total`` of the node
    weight. Bins are numbered in leaf order, so contiguous bin runs are
    subtree-contiguous. On a card the whole split is one ``prefix_split``
    kernel between one copy of the weights and boundaries in and one of the
    bins out.

    The prefix sum is float32, like the reference's. A scan taken in
    another order (torch's CPU cumsum accumulates in float64, the kernel in
    a block scan of its own fixed order) can move a midpoint that sits
    within rounding of a capacity boundary to the neighbouring bin; integer
    node weights (sums below 2**24) are exact in any order.

    ``seed`` is accepted for signature parity with
    :func:`initial_partition`; the prefix split is deterministic.
    """
    del seed
    dev = resolve_device(device)
    speed = topo.bin_speed
    if speed is not None and not (np.asarray(speed) > 0).all():
        raise ValueError("zero-capacity bin reached the partitioner — "
                         "mask dead leaves instead of zeroing bin_speed")
    k = topo.k
    caps = (np.ones(k, dtype=np.float64) if speed is None
            else np.asarray(speed, dtype=np.float64))
    total_w = float(g.node_weight.sum())
    bounds = np.cumsum(caps)[:-1] / caps.sum() * total_w   # [k-1]
    return ops.prefix_split_host(g.node_weight,
                                 bounds.astype(np.float32), k, dev)


def random_partition(n: int, k: int, node_weight: np.ndarray = None,
                     seed: int = 0) -> np.ndarray:
    """Balanced random assignment baseline (round-robin over a shuffle)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    part = np.zeros(n, dtype=np.int32)
    part[order] = np.arange(n) % k
    return part
