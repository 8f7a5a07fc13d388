"""Baseline partitioners the paper compares the makespan objective against.

Twin of ``repro/core/baselines.py``:

* ``total_cut_partition``: classic multilevel total-cut minimisation under
  a hard balance constraint (the KaHIP/Metis objective), on the host
  coarsening and greedy-grow initial partition the partitioner's host
  backend uses, with cut-gain label propagation at every level. Its
  ``[n, k]`` connectivity rows come from the ``partition_gain`` kernel
  over each level's ELL layout. The C1-C3 comparison point.
* ``flat_twice_partition``: the Lynx code's emulation of hierarchy (flat
  partitioning applied twice: across the root's children, then within
  each child), blind to link costs. The C4 comparison point.
* ``random_partition`` (re-exported): the sanity floor.

All return plain assignments; ``score_all`` judges every method under
every metric, through the ``quotient_link_loads`` kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import objective
from repro_torch.core.coarsen import coarsen
from repro_torch.core.draws import DrawSource, TorchDraws
from repro_torch.core.initial import initial_partition
from repro_torch.core.initial import random_partition  # noqa: F401
from repro_torch.core.topology import TreeTopology, flat_topology
from repro_torch.graph.graph import Graph, subgraph
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class CutRefineConfig:
    rounds: int = 64
    damping: float = 0.5
    imbalance: float = 0.05     # hard balance constraint epsilon
    seed: int = 0


def _cut_refine(part: torch.Tensor, g: Graph, k: int, cfg: CutRefineConfig,
                draws: DrawSource) -> torch.Tensor:
    """Label-propagation refinement of the TOTAL CUT under a hard balance
    constraint, ``cfg.rounds`` rounds on ``part`` (int32, on its device):
    move v to its neighbour-heaviest other bin when that reduces the cut
    and keeps every bin below ``(1 + eps) * total / k``, gated by
    ``u_gate < damping`` and thinned per destination bin to its room.

    ``conn[v, j]``, the weight of v's arcs into bin j, is the reference's
    ``segment_sum(edge_weight, senders * k + part[receivers])``, summed
    here by ``partition_gain`` over the level's ELL rows in slot order;
    both orders are exact on integer weights. The uniforms come from
    ``draws.cut_refine(cfg.seed, n)``, a stream that starts afresh at
    every level as the reference's key does."""
    dev = part.device
    n = g.n_nodes
    idx, ew = kops.to_ell(n, g.senders, g.receivers, g.edge_weight)
    ell_idx = torch.as_tensor(idx, dtype=torch.int32, device=dev)
    ell_w = torch.as_tensor(ew, dtype=torch.float32, device=dev)
    node_weight = torch.as_tensor(g.node_weight, dtype=torch.float32,
                                  device=dev)
    cap = (1.0 + cfg.imbalance) * node_weight.sum() / k
    rows = torch.arange(n, device=dev)
    stream = draws.cut_refine(cfg.seed, n)
    for _ in range(cfg.rounds):
        u = torch.as_tensor(next(stream), dtype=torch.float32, device=dev)
        conn = kops.partition_gain(part, ell_idx, ell_w, k)
        p64 = part.long()
        own = conn[rows, p64]
        # masked in place: cand differs from the own bin wherever k > 1, so
        # conn[cand] is unmasked; at k = 1 the gain reads -inf, not 0, and
        # fails "gain > 0" all the same
        conn[rows, p64] = float("-inf")
        cand = torch.argmax(conn, dim=1)        # first maximum, as jnp.argmax
        gain = conn[rows, cand] - own
        comp = objective.comp_loads(part, node_weight, k)
        want = (gain > 0) & (u[0] < cfg.damping)
        inflow = torch.zeros(k, dtype=torch.float32, device=dev)
        inflow.index_add_(0, cand, torch.where(want, node_weight,
                                               torch.zeros_like(node_weight)))
        room = torch.clamp_min(cap - comp, 0.0)
        ratio = torch.where(inflow > 0,
                            torch.clamp_max(room / torch.clamp_min(inflow,
                                                                   1e-9), 1.0),
                            torch.zeros_like(inflow))
        keep = want & (u[1] < ratio[cand])
        part = torch.where(keep, cand.to(part.dtype), part)
    return part


def total_cut_partition(g: Graph, k: int,
                        cfg: Optional[CutRefineConfig] = None,
                        coarse_factor: int = 24, *,
                        device: DeviceLike = None,
                        draws: Optional[DrawSource] = None) -> np.ndarray:
    """Multilevel total-cut partitioner (balance-constrained) on ``device``
    (``None`` = CUDA): host coarsening and greedy grow on
    ``flat_topology(k)``, then :func:`_cut_refine` at every level, finest
    last, projected down the levels. ``draws`` replaces the default
    ``torch.Generator`` source (``core/draws.py``)."""
    cfg = cfg or CutRefineConfig()
    dev = resolve_device(device)
    draws = draws if draws is not None else TorchDraws(cfg.seed, dev)
    levels = coarsen(g, k, seed=cfg.seed, coarse_factor=coarse_factor)
    part = torch.as_tensor(
        initial_partition(levels[-1].graph, flat_topology(k), seed=cfg.seed),
        dtype=torch.int32, device=dev)
    for li in range(len(levels) - 1, -1, -1):
        part = _cut_refine(part, levels[li].graph, k, cfg, draws)
        if li > 0:
            part = part[torch.as_tensor(levels[li - 1].fine_to_coarse,
                                        dtype=torch.int64, device=dev)]
    return part.cpu().numpy().astype(np.int32)


def flat_twice_partition(g: Graph, topo: TreeTopology,
                         cfg: Optional[CutRefineConfig] = None, *,
                         device: DeviceLike = None,
                         draws: Optional[DrawSource] = None) -> np.ndarray:
    """Hierarchy emulation by two flat total-cut partitionings: split the
    graph across the root's children, then split each child's subgraph
    across its own leaves, every sub-problem with the same ``cfg`` (and so
    the same draws, as in the reference)."""
    cfg = cfg or CutRefineConfig()
    dev = resolve_device(device)
    draws = draws if draws is not None else TorchDraws(cfg.seed, dev)
    root = int(np.nonzero(topo.parent < 0)[0][0])
    groups = [topo.leaves_under(int(c)) for c in topo.children(root)]
    groups = [gr for gr in groups if gr.size > 0]
    part = np.zeros(g.n_nodes, dtype=np.int32)
    if len(groups) == 1:
        top = np.zeros(g.n_nodes, dtype=np.int32)
    else:
        top = total_cut_partition(g, len(groups), cfg, device=dev,
                                  draws=draws)
    for gi, bins in enumerate(groups):
        nodes = np.nonzero(top == gi)[0]
        if nodes.size == 0:
            continue
        if bins.size == 1:
            part[nodes] = bins[0]
            continue
        sub = total_cut_partition(subgraph(g, nodes), bins.size, cfg,
                                  device=dev, draws=draws)
        part[nodes] = bins[sub]
    return part


def score_all(g: Graph, topo: TreeTopology, part: np.ndarray,
              device: DeviceLike = None) -> dict:
    """Uniform scorecard: makespan / comp_max / comm_max / total cut /
    max communication volume / imbalance, on ``device`` (``None`` = CUDA).
    On a heterogeneous machine (``topo.bin_speed``) the comp terms are
    capacity-normalized and imbalance is measured against the
    per-unit-speed fair share."""
    dev = resolve_device(device)
    p = torch.as_tensor(np.asarray(part), dtype=torch.int32, device=dev)
    s = torch.as_tensor(g.senders, dtype=torch.int32, device=dev)
    r = torch.as_tensor(g.receivers, dtype=torch.int32, device=dev)
    nw = torch.as_tensor(g.node_weight, dtype=torch.float32, device=dev)
    br, W = objective.makespan_tree_with_quotient(
        p, s, r, g.edge_weight, nw, topo.subtree, topo.F_l, k=topo.k,
        speed=topo.bin_speed, device=dev)
    cvol = objective.comm_volumes(p, s, r, nw, topo.k)
    speed = (None if topo.bin_speed is None
             else np.asarray(topo.bin_speed, dtype=np.float32))
    fair = g.total_node_weight() / (topo.k if speed is None
                                    else float(speed.sum()))
    return {
        "makespan": float(br.makespan),
        "comp_max": float(br.comp_max),
        "comm_max": float(br.comm_max),
        "total_cut": float(objective.total_cut(W)),
        "max_cvol": float(cvol.max()),
        "imbalance": float(br.comp_max / fair) - 1.0,
    }
