"""C1 on the port: in the SpMV regime the step time is set by the
bottleneck (max over bins and links), so minimising the makespan beats
minimising the total cut. Twin of ``bench_makespan_vs_cut.py`` over
``repro_torch``.

One row per (graph, machine): the modelled step of the makespan
partitioner (device backend) against the total-cut partitioner,
flat-twice and random, and each method's total cut. Run from the
repository's root:

    PYTHONPATH=src python -m benchmarks.torch_bench_makespan_vs_cut
    REPRO_BENCH_DEVICE=cpu REPRO_BENCH_TINY=1 PYTHONPATH=src \\
        python -m benchmarks.torch_bench_makespan_vs_cut
"""
from __future__ import annotations

from typing import Optional

from benchmarks.torch_common import (bench_device, emit, spmv_step_time,
                                     timed, tiny)
from repro_torch.core import baselines
from repro_torch.core.partitioner import PartitionConfig, partition
from repro_torch.core.topology import balanced_tree, production_tree
from repro_torch.graph.generators import grid2d, grid3d, rmat

_G2, _G3 = tiny(64, 16), tiny(16, 6)
_RN, _RM = tiny((20000, 120000), (2000, 12000))
CASES = [
    (f"grid2d_{_G2}", lambda: grid2d(_G2, _G2),
     lambda: balanced_tree((2, 8), level_cost=(8.0, 1.0))),
    (f"grid3d_{_G3}", lambda: grid3d(_G3, _G3, _G3),
     lambda: production_tree(2, 4, 4)),
    (f"rmat_{_RN}", lambda: rmat(_RN, _RM, seed=1),
     lambda: balanced_tree((2, 8), level_cost=(8.0, 1.0))),
]


def c1_row(g, topo, dev,
           cfg: Optional[baselines.CutRefineConfig] = None) -> dict:
    """Every method on one (graph, machine), each seeded with
    ``cfg.seed``: ``parts`` (each method's assignment), ``seconds``,
    ``scorecards`` (``score_all`` and the modelled ``step``) and
    ``speedup_vs_cut`` (the cut partitioner's step over the makespan
    partitioner's)."""
    cfg = cfg or baselines.CutRefineConfig()
    methods = {
        "ours": lambda: partition(g, topo, PartitionConfig(
            seed=cfg.seed, backend="device"), device=dev).part,
        "cut": lambda: baselines.total_cut_partition(g, topo.k, cfg,
                                                     device=dev),
        "flat_twice": lambda: baselines.flat_twice_partition(
            g, topo, cfg, device=dev),
        "random": lambda: baselines.random_partition(g.n_nodes, topo.k,
                                                     seed=cfg.seed),
    }
    parts, secs = {}, {}
    for method, fn in methods.items():
        parts[method], secs[method] = timed(fn)
    cards = {m: spmv_step_time(g, topo, p, dev) for m, p in parts.items()}
    return {"parts": parts, "seconds": secs, "scorecards": cards,
            "speedup_vs_cut": cards["cut"]["step"] / cards["ours"]["step"]}


def run() -> None:
    dev = bench_device()
    for name, mk_g, mk_t in CASES:
        row = c1_row(mk_g(), mk_t(), dev)
        s, secs = row["scorecards"], row["seconds"]
        emit("C1_makespan_vs_cut", name, secs["ours"],
             step_ours=round(s["ours"]["step"], 1),
             step_cut=round(s["cut"]["step"], 1),
             step_flat_twice=round(s["flat_twice"]["step"], 1),
             step_rand=round(s["random"]["step"], 1),
             speedup_vs_cut=round(row["speedup_vs_cut"], 3),
             cut_ours=round(s["ours"]["total_cut"], 1),
             cut_cut=round(s["cut"]["total_cut"], 1),
             cut_s=round(secs["cut"], 3),
             flat_twice_s=round(secs["flat_twice"], 3))


if __name__ == "__main__":
    run()
