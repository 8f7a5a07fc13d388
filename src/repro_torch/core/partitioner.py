"""Multilevel entry point for graph-constrained makespan partitioning (torch).

Twin of ``repro/core/partitioner.py``. Pipeline (classic V-cycle,
bottleneck objective throughout):

  coarsen (heavy-edge matching)  ->  initial partition on the coarsest
  graph  ->  uncoarsen: project + bottleneck refinement at every level
  (dense all-bin gains on coarse levels, sampled candidates on fine ones).

``PartitionConfig.backend`` selects the V-cycle front end: ``"host"``
(numpy coarsening + greedy grow, copies of the reference) or ``"device"``
(torch segment-op coarsening through the ``match_keys`` kernel + the
capacity-prefix initial through ``bucket_assign``). Refinement and the final
evaluation run on the device for both, through ``quotient_link_loads`` and
``partition_gain``. Between levels the ``[S, n]`` partitions stay on the
device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import objective
from repro_torch.core import refine as refine_mod
from repro_torch.core.coarsen import coarsen, coarsen_device
from repro_torch.core.draws import DrawSource, TorchDraws
from repro_torch.core.initial import (initial_partition,
                                      initial_partition_device,
                                      random_partition)
from repro_torch.core.reference import makespan_ref
from repro_torch.core.refine import RefineConfig
from repro_torch.core.topology import TreeTopology
from repro_torch.graph.graph import Graph


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    refine: RefineConfig = dataclasses.field(default_factory=RefineConfig)
    coarse_factor: int = 24
    max_levels: int = 40
    seed: int = 0
    initial: str = "hierarchical"   # or "random"
    final_rounds: Optional[int] = None  # extra rounds on the finest level
    seeds: int = 1                  # best-of-S refinement (>= 1)
    # "host": numpy coarsening + greedy-grow initial;
    # "device": torch coarsening + capacity-prefix initial on the device
    backend: str = "host"


@dataclasses.dataclass
class PartitionResult:
    part: np.ndarray                # [n] bin per vertex
    makespan: float
    comp: np.ndarray                # [k] (comp/speed when topo.bin_speed set)
    comm: np.ndarray                # [L]
    comp_max: float
    comm_max: float
    total_cut: float
    seconds: float
    level_makespans: List[float]


def _evaluate(g: Graph, topo: TreeTopology, part,
              device: torch.device) -> PartitionResult:
    """Score ``part`` on the device and bring the breakdown to the host."""
    part_t = torch.as_tensor(part, dtype=torch.int32, device=device)
    s = torch.as_tensor(g.senders, dtype=torch.int32, device=device)
    r = torch.as_tensor(g.receivers, dtype=torch.int32, device=device)
    w = torch.as_tensor(g.edge_weight, dtype=torch.float32, device=device)
    br, W = objective.makespan_tree_with_quotient(
        part_t, s, r, w, g.node_weight, topo.subtree, topo.F_l, k=topo.k,
        speed=topo.bin_speed, device=device)
    return PartitionResult(
        part=part_t.cpu().numpy(), makespan=float(br.makespan),
        comp=br.comp.cpu().numpy(), comm=br.comm.cpu().numpy(),
        comp_max=float(br.comp_max), comm_max=float(br.comm_max),
        total_cut=float(objective.total_cut(W)), seconds=0.0,
        level_makespans=[])


def _initial_parts(coarsest: Graph, topo: TreeTopology,
                   cfg: PartitionConfig, device: torch.device) -> np.ndarray:
    """[S, n_coarse] initial partitions. Slot 0 is exactly the ``seeds=1``
    start; later slots alternate hierarchical growing and balanced random
    assignments at shifted seeds for diversity."""
    parts = []
    for i in range(cfg.seeds):
        hier = (cfg.initial == "hierarchical") if i == 0 else (i % 2 == 1)
        if hier and cfg.backend == "device":
            parts.append(initial_partition_device(coarsest, topo,
                                                  seed=cfg.seed + i,
                                                  device=device))
        elif hier:
            parts.append(initial_partition(coarsest, topo, seed=cfg.seed + i))
        else:
            parts.append(random_partition(coarsest.n_nodes, topo.k,
                                          coarsest.node_weight,
                                          seed=cfg.seed + i))
    return np.stack(parts)


def partition(g: Graph, topo: TreeTopology,
              cfg: Optional[PartitionConfig] = None, *,
              device: DeviceLike = None,
              draws: Optional[DrawSource] = None) -> PartitionResult:
    """Partition ``g`` onto the compute bins of ``topo`` minimizing the
    makespan. Runs on ``device`` (``None`` = CUDA; ``"cpu"`` runs the plain
    PyTorch versions of the kernels). ``draws`` replaces the default
    ``torch.Generator`` random source (``core/draws.py``)."""
    cfg = cfg or PartitionConfig()
    if cfg.seeds < 1:
        raise ValueError(f"seeds must be >= 1, got {cfg.seeds}")
    if cfg.backend not in ("host", "device"):
        raise ValueError(f"backend must be 'host' or 'device', "
                         f"got {cfg.backend!r}")
    dev = resolve_device(device)
    draws = draws if draws is not None else TorchDraws(cfg.seed, dev)
    t0 = time.time()
    if cfg.backend == "device":
        levels = coarsen_device(g, topo.k, seed=cfg.seed,
                                coarse_factor=cfg.coarse_factor,
                                max_levels=cfg.max_levels, device=dev,
                                draws=draws)
    else:
        levels = coarsen(g, topo.k, seed=cfg.seed,
                         coarse_factor=cfg.coarse_factor,
                         max_levels=cfg.max_levels)
    history: List[float] = []
    parts = torch.as_tensor(_initial_parts(levels[-1].graph, topo, cfg, dev),
                            dtype=torch.int32, device=dev)
    for li in range(len(levels) - 1, -1, -1):
        lg = levels[li].graph
        rcfg = cfg.refine
        if li == 0 and cfg.final_rounds is not None:
            rcfg = dataclasses.replace(rcfg, rounds=cfg.final_rounds)
        dense = lg.n_nodes * topo.k <= rcfg.dense_threshold
        lv = refine_mod.level_arrays(lg, topo, dense, dev)
        parts, ms, _ = refine_mod.refine_batch_tensors(lv, parts, rcfg, dense,
                                                       draws)
        history.append(float(ms.min()))
        if li > 0:
            f2c = torch.as_tensor(levels[li - 1].fine_to_coarse,
                                  dtype=torch.int64, device=dev)
            parts = parts[:, f2c]
    part = parts[int(torch.argmin(ms))]
    res = _evaluate(g, topo, part, dev)
    res.seconds = time.time() - t0
    res.level_makespans = history
    return res


def verify(g: Graph, topo: TreeTopology, res: PartitionResult,
           atol: float = 1e-3) -> None:
    """Cross-check the device evaluation against the path-walking oracle."""
    m_ref, comp_ref, comm_ref = makespan_ref(res.part, g, topo)
    if not np.allclose(res.comp, comp_ref, atol=atol):
        raise AssertionError("comp mismatch vs oracle")
    if not np.allclose(res.comm, comm_ref, atol=atol):
        raise AssertionError("comm mismatch vs oracle")
    if abs(res.makespan - m_ref) > atol * max(1.0, m_ref):
        raise AssertionError(f"makespan {res.makespan} != oracle {m_ref}")
