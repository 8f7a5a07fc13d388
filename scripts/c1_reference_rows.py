"""The JAX reference's C1 rows over seeds: the band the port's ``c1`` phase
(``chip_smoke.py``) is held to.

For each case of ``benchmarks/bench_makespan_vs_cut.py``'s full tier and
the port's full cell (``grid3d(64, 64, 64)`` on ``gpu-superpod``), and each
seed, the reference runs ``partition`` (device backend),
``total_cut_partition``, ``flat_twice_partition`` and ``random_partition``
with that seed, scores them with ``baselines.score_all`` and prints one
JSON line: each method's modelled SpMV step (``max(comp_max, comm_max)``,
as ``benchmarks/common.py``), total cut and imbalance, and
``speedup_vs_cut`` (the cut partitioner's step over the makespan
partitioner's). Run on a CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/c1_reference_rows.py \\
        [--seeds 0,1,2,3] [--cases grid2d_64,grid3d_16,rmat_20000,full]
"""
from __future__ import annotations

import argparse
import json
import time

from repro.core import baselines
from repro.core.machine import MachineSpec
from repro.core.partitioner import PartitionConfig, partition
from repro.core.topology import balanced_tree, production_tree
from repro.graph.generators import grid2d, grid3d, rmat

CASES = {
    "grid2d_64": (lambda: grid2d(64, 64),
                  lambda: balanced_tree((2, 8), level_cost=(8.0, 1.0))),
    "grid3d_16": (lambda: grid3d(16, 16, 16),
                  lambda: production_tree(2, 4, 4)),
    "rmat_20000": (lambda: rmat(20000, 120000, seed=1),
                   lambda: balanced_tree((2, 8), level_cost=(8.0, 1.0))),
    "full": (lambda: grid3d(64, 64, 64),
             lambda: MachineSpec.preset("gpu-superpod").tree()),
}


def row(name: str, seed: int) -> dict:
    mk_g, mk_t = CASES[name]
    g, topo = mk_g(), mk_t()
    cfg = baselines.CutRefineConfig(seed=seed)
    t0 = time.time()
    parts = {
        "ours": partition(g, topo, PartitionConfig(seed=seed,
                                                   backend="device")).part,
        "cut": baselines.total_cut_partition(g, topo.k, cfg),
        "flat_twice": baselines.flat_twice_partition(g, topo, cfg),
        "random": baselines.random_partition(g.n_nodes, topo.k, seed=seed),
    }
    out = {"case": name, "seed": seed, "seconds": time.time() - t0}
    for method, part in parts.items():
        s = baselines.score_all(g, topo, part)
        out[method] = {"step": max(s["comp_max"], s["comm_max"]),
                       "total_cut": s["total_cut"],
                       "imbalance": s["imbalance"]}
    out["speedup_vs_cut"] = out["cut"]["step"] / out["ours"]["step"]
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args()
    for name in args.cases.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(row(name, seed)), flush=True)


if __name__ == "__main__":
    main()
