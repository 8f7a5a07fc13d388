"""Baseline scorecard: every assignment judged under every metric.

Twin of ``score_all`` in ``repro/core/baselines.py``. The baseline
partitioners there (``total_cut_partition``, ``flat_twice_partition``) are
not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import objective
from repro_torch.core.topology import TreeTopology
from repro_torch.graph.graph import Graph


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
