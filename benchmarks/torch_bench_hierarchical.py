"""C4 on the port: direct tree-aware (hierarchical) partitioning against
the Lynx code's emulation (flat partitioning applied twice), and the hybrid
that refines the emulation's partition under the bottleneck objective.
Twin of ``bench_hierarchical.py`` over ``repro_torch``.

The reference loses its own claim on the 3-D grid (flat-twice wins there),
so the port is held to the reference's rows, not to the paper's claim. Run
from the repository's root:

    PYTHONPATH=src python -m benchmarks.torch_bench_hierarchical
    REPRO_BENCH_DEVICE=cpu REPRO_BENCH_TINY=1 PYTHONPATH=src \\
        python -m benchmarks.torch_bench_hierarchical
"""
from __future__ import annotations

from benchmarks.torch_common import (bench_device, emit, spmv_step_time,
                                     timed, tiny)
from repro_torch.core import baselines
from repro_torch.core.partitioner import PartitionConfig, partition
from repro_torch.core.refine import RefineConfig, refine
from repro_torch.core.topology import production_tree
from repro_torch.graph.generators import grid3d, rmat

_SIDE = tiny(14, 6)
_N, _M = tiny((10000, 60000), (1000, 6000))
CASES = [(f"grid3d_{_SIDE}", lambda: grid3d(_SIDE, _SIDE, _SIDE)),
         (f"rmat_{_N}", lambda: rmat(_N, _M, seed=2))]
FINAL_ROUNDS = tiny(160, 8)
HYBRID_ROUNDS = tiny(96, 8)


def machine():
    return production_tree(2, 4, 4)       # 32 chips, DCN/ICI asymmetry


def hierarchical_row(g, topo, device, seed: int = 0) -> dict:
    """One case, seeded with ``seed``: ``partition`` with its final rounds,
    flat-twice, and the hybrid (``refine`` from flat-twice's partition);
    each one's modelled step, the ratios, seconds, and what was scored,
    ``scored``: ``(graph, machine, part, scorecard)`` for a host
    re-evaluation."""
    ours, t_ours = timed(partition, g, topo, PartitionConfig(
        seed=seed, final_rounds=FINAL_ROUNDS), device=device)
    flat2, t_flat = timed(baselines.flat_twice_partition, g, topo,
                          baselines.CutRefineConfig(seed=seed),
                          device=device)
    (hyb, _, _), t_hyb = timed(refine, g, topo, flat2,
                               RefineConfig(rounds=HYBRID_ROUNDS, seed=seed),
                               device=device)
    parts = {"hier": ours.part, "flat_twice": flat2, "hybrid": hyb}
    cards = {m: spmv_step_time(g, topo, p, device) for m, p in parts.items()}
    return dict(step_hier=cards["hier"]["step"],
                step_flat_twice=cards["flat_twice"]["step"],
                step_hybrid=cards["hybrid"]["step"],
                ratio=cards["flat_twice"]["step"] / cards["hier"]["step"],
                hybrid_vs_flat=cards["flat_twice"]["step"]
                / max(cards["hybrid"]["step"], 1e-9),
                secs_hier=t_ours, secs_flat=t_flat, secs_hybrid=t_hyb,
                scored=[(g, topo, parts[m], cards[m]) for m in parts])


def run() -> None:
    dev = bench_device()
    topo = machine()
    for name, mk_g in CASES:
        r = hierarchical_row(mk_g(), topo, dev)
        emit("C4_hierarchical", name, r["secs_hier"],
             step_hier=round(r["step_hier"], 1),
             step_flat_twice=round(r["step_flat_twice"], 1),
             step_hybrid=round(r["step_hybrid"], 1),
             ratio=round(r["ratio"], 3),
             hybrid_vs_flat=round(r["hybrid_vs_flat"], 3),
             secs_hier=round(r["secs_hier"], 2),
             secs_flat=round(r["secs_flat"], 2))


if __name__ == "__main__":
    run()
