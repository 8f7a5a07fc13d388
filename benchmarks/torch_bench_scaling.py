"""Partitioner scalability on the port: wall time and quality against
graph size, against the bin count k (the production tree is 512 compute
bins), and the host against the device V-cycle front end, end to end
through ``partition`` and the mesh-mapping search. Twin of
``bench_scaling.py`` over ``repro_torch``; writes
``BENCH_torch_scaling.json`` in the working directory. Run from the
repository's root:

    PYTHONPATH=src python -m benchmarks.torch_bench_scaling
    REPRO_BENCH_DEVICE=cpu REPRO_BENCH_TINY=1 PYTHONPATH=src \\
        python -m benchmarks.torch_bench_scaling

The device rows run every partitioner kernel: ``match_round`` in the
coarsening, ``prefix_split`` for the initial split, ``quotient_link_loads``
and ``partition_gain`` in the refinement.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np
import torch

from benchmarks.torch_common import (TINY, bench_device, emit, public,
                                     timed, tiny)
from repro_torch import resolve_device
from repro_torch.core import baselines, mapping
from repro_torch.core.machine import resolve
from repro_torch.core.partitioner import PartitionConfig, partition
from repro_torch.core.refine import RefineConfig
from repro_torch.core.topology import balanced_tree, production_tree
from repro_torch.graph.generators import grid2d, rmat
from repro_torch.kernels.quotient_link_loads import quotient_matrix

SIZES = tiny([(10_000, 60_000), (100_000, 600_000), (400_000, 2_400_000)],
             [(2_000, 12_000)])
TREES = tiny([(1, 4, 4), (1, 16, 16), (2, 16, 16)], [(1, 4, 4), (1, 16, 16)])
GRID_SIDE = tiny(256, 48)
VCYCLE = tiny([(2_000, 10_000), (20_000, 100_000), (200_000, 1_000_000)],
              [(600, 3_000)])


def _want(name: str, only: Optional[Sequence[str]]) -> bool:
    return only is None or name in only


def scaling_size(device, seed: int = 0,
                 only: Optional[Sequence[str]] = None) -> List[dict]:
    """Size scaling at k = 32 (rows ``size_<n>``)."""
    rows = []
    topo = balanced_tree((2, 4, 4), level_cost=(8.0, 1.0, 1.0))
    for n, m in SIZES:
        if not _want(f"size_{n}", only):
            continue
        g = rmat(n, m, seed=0)
        cfg = PartitionConfig(seed=seed,
                              refine=RefineConfig(rounds=tiny(32, 8)))
        res, secs = timed(partition, g, topo, cfg, device=device)
        rand = baselines.random_partition(n, topo.k)
        m_rand = baselines.score_all(g, topo, rand, device=device)["makespan"]
        rows.append(dict(name=f"size_{n}", bench_name=f"rmat_n{n}", m=m,
                         seconds=secs, makespan=res.makespan,
                         vs_random=m_rand / res.makespan,
                         edges_per_sec=m / max(secs, 1e-9),
                         scored=[(g, topo, res.part,
                                  {"makespan": res.makespan})]))
    return rows


def scaling_k(device, seed: int = 0,
              only: Optional[Sequence[str]] = None) -> List[dict]:
    """k scaling to the production tree, 512 bins (rows
    ``k_<pods>x<rows>x<chips>``)."""
    rows = []
    g = grid2d(GRID_SIDE, GRID_SIDE)
    for pods, rws, chips in TREES:
        name = f"k_{pods}x{rws}x{chips}"
        if not _want(name, only):
            continue
        topo = production_tree(pods, rws, chips)
        cfg = PartitionConfig(seed=seed,
                              refine=RefineConfig(rounds=tiny(24, 8)))
        res, secs = timed(partition, g, topo, cfg, device=device)
        rows.append(dict(name=name, bench_name=f"tree_{pods}x{rws}x{chips}",
                         k=topo.k, seconds=secs, makespan=res.makespan,
                         comp_max=res.comp_max, comm_max=res.comm_max,
                         scored=[(g, topo, res.part,
                                  {"makespan": res.makespan,
                                   "comp_max": res.comp_max,
                                   "comm_max": res.comm_max})]))
    return rows


def vcycle(device, seed: int = 0,
           only: Optional[Sequence[str]] = None) -> List[dict]:
    """Host against device V-cycle front end, end to end: ``partition``
    onto a k = 64 tree, its 64 x 64 quotient traffic (diagonal zeroed)
    mapped onto the ``torus-2d`` machine by ``mapping.search`` (rows
    ``vcycle_<m>``)."""
    dev = resolve_device(device)
    rows = []
    mtopo = resolve("torus-2d").topology()
    ptopo = balanced_tree((8, 8))                  # k = 64, the 8 x 8 torus
    for n, m in VCYCLE:
        if not _want(f"vcycle_{m}", only):
            continue
        g = rmat(n, m, seed=0)
        row = dict(name=f"vcycle_{m}", n=n, m=m, scored=[])
        for backend in ("host", "device"):
            cfg = PartitionConfig(seed=seed, backend=backend,
                                  refine=RefineConfig(rounds=tiny(16, 8)))
            res, p_secs = timed(partition, g, ptopo, cfg, device=dev)
            W = quotient_matrix(
                torch.as_tensor(res.part, dtype=torch.int32, device=dev),
                torch.as_tensor(g.senders, device=dev),
                torch.as_tensor(g.receivers, device=dev),
                torch.as_tensor(g.edge_weight, device=dev),
                ptopo.k).cpu().numpy().astype(np.float64)
            np.fill_diagonal(W, 0.0)
            mres, m_secs = timed(mapping.search, (8, 8), mtopo, W,
                                 n_random=tiny(8, 2), seed=0, device=dev)
            row.update({f"{backend}_partition_s": p_secs,
                        f"{backend}_map_s": m_secs,
                        f"{backend}_s": p_secs + m_secs,
                        f"{backend}_makespan": res.makespan,
                        f"{backend}_bottleneck": float(mres.bottleneck)})
            row["scored"].append((g, ptopo, res.part,
                                  {"makespan": res.makespan}))
        row["speedup"] = row["host_s"] / max(row["device_s"], 1e-9)
        rows.append(row)
    return rows


def run() -> None:
    dev = bench_device()
    out = {"size": [], "k": [], "vcycle": [], "tiny": TINY,
           "device": str(dev)}
    for r in scaling_size(dev):
        emit("scaling_size", r["bench_name"], r["seconds"],
             makespan=round(r["makespan"], 1),
             vs_random=round(r["vs_random"], 2),
             edges_per_sec=int(r["edges_per_sec"]))
        out["size"].append(public(r))
    for r in scaling_k(dev):
        emit("scaling_k", r["bench_name"], r["seconds"], k=r["k"],
             makespan=round(r["makespan"], 1),
             comp_max=round(r["comp_max"], 1),
             comm_max=round(r["comm_max"], 1))
        out["k"].append(public(r))
    for r in vcycle(dev):
        for backend in ("host", "device"):
            emit("scaling_vcycle", f"{backend}_m{r['m']}", r[f"{backend}_s"],
                 partition_s=round(r[f"{backend}_partition_s"], 4),
                 map_s=round(r[f"{backend}_map_s"], 4),
                 makespan=round(r[f"{backend}_makespan"], 1),
                 bottleneck=round(r[f"{backend}_bottleneck"], 4))
        out["vcycle"].append(public(r))
    with open("BENCH_torch_scaling.json", "w") as f:
        json.dump(out, f, indent=1)
    best = max(r["speedup"] for r in out["vcycle"])
    print(f"wrote BENCH_torch_scaling.json (device V-cycle best speedup "
          f"{best:.2f}x over host, {len(out['size'])} size cells)")


if __name__ == "__main__":
    run()
