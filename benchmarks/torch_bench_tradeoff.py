"""C3 on the port, the F trade-off: one makespan objective with a varying
communication factor F sweeps out solutions from load balance to
communication; the fixed-balance-constraint baseline reaches only its one
epsilon point. Twin of ``bench_tradeoff.py`` over ``repro_torch``.

Rows: the makespan partitioner at F = 0.05, 0.2, 1 and 5 (imbalance,
bottleneck communication over F, makespan), the total-cut baseline at
epsilon 0.03 and 0.10 scored on the F = 1 machine, and whether the
bottleneck communication falls as F grows. Run from the repository's root:

    PYTHONPATH=src python -m benchmarks.torch_bench_tradeoff
    REPRO_BENCH_DEVICE=cpu REPRO_BENCH_TINY=1 PYTHONPATH=src \\
        python -m benchmarks.torch_bench_tradeoff
"""
from __future__ import annotations

from typing import List

from benchmarks.torch_common import bench_device, emit, timed, tiny
from repro_torch.core import baselines
from repro_torch.core.partitioner import PartitionConfig, partition
from repro_torch.core.topology import balanced_tree
from repro_torch.graph.generators import grid2d

SIDE = tiny(48, 16)
F_SWEEP = (0.05, 0.2, 1.0, 5.0)
EPSILONS = (0.03, 0.10)


def machine(F: float):
    return balanced_tree((2, 4), F=F, level_cost=(6.0 * F, F))


def tradeoff_rows(device, seed: int = 0) -> List[dict]:
    """Every row of the bench, each seeded with ``seed``: ``name``, its
    numbers, ``seconds``, and what was scored, ``scored``: ``(graph,
    machine, part, scorecard)`` for a host re-evaluation."""
    g = grid2d(SIDE, SIDE)
    rows, comms = [], []
    for F in F_SWEEP:
        topo = machine(F)
        res, secs = timed(partition, g, topo, PartitionConfig(seed=seed),
                          device=device)
        s = baselines.score_all(g, topo, res.part, device=device)
        comms.append(s["comm_max"] / F)
        rows.append(dict(name=f"makespan_F{F}", seconds=secs,
                         imbalance=s["imbalance"],
                         bottleneck_comm=s["comm_max"] / F,
                         makespan=s["makespan"],
                         scored=[(g, topo, res.part, s)]))
    for eps in EPSILONS:
        cut, secs = timed(baselines.total_cut_partition, g, 8,
                          baselines.CutRefineConfig(imbalance=eps, seed=seed),
                          device=device)
        topo = machine(1.0)
        s = baselines.score_all(g, topo, cut, device=device)
        rows.append(dict(name=f"cut_eps{eps}", seconds=secs,
                         imbalance=s["imbalance"],
                         bottleneck_comm=s["comm_max"],
                         makespan=s["makespan"],
                         scored=[(g, topo, cut, s)]))
    rows.append(dict(name="monotonic_comm_with_F", seconds=0.0,
                     monotone=bool(all(comms[i] >= comms[i + 1] - 1e-6
                                       for i in range(len(comms) - 1)))))
    return rows


def run() -> None:
    for row in tradeoff_rows(bench_device()):
        if "makespan" in row:
            emit("C3_tradeoff", row["name"], row["seconds"],
                 imbalance=round(row["imbalance"], 3),
                 bottleneck_comm=round(row["bottleneck_comm"], 1),
                 makespan=round(row["makespan"], 1))
        else:
            emit("C3_tradeoff", row["name"], 0.0, monotone=row["monotone"])


if __name__ == "__main__":
    run()
