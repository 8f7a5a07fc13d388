"""Port parity for the paper's remaining claims (C2, C3, C4, the section
3.1 variants), on the CPU at small sizes: the port's bench twins against
the reference's benches on the same graphs and partitions.

- C2: the port's host walk ``bfs_round_cost`` equals the reference's on
  the same part; the twin's own path, the plain ``quotient_link_loads``
  over each BFS round's active arcs (times 2), equals the walk round by
  round.
- C3 / C4: ``spmv_step_time`` and ``score_all`` on the reference's own
  partitions equal the reference's within rel 1e-6.
- Variants: the torus rows equal the reference's.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import bench_spmspv as jc2  # noqa: E402  (the repo's)
from benchmarks import common as jcommon
from benchmarks import torch_bench_spmspv as c2
from benchmarks import torch_bench_variants as variants
from benchmarks import torch_common
from repro.core import baselines as jbaselines
from repro.core import reference as jreference
from repro.core.partitioner import PartitionConfig as JPartitionConfig
from repro.core.partitioner import partition as jpartition
from repro.core.topology import balanced_tree as jbalanced_tree
from repro.core.topology import production_tree as jproduction_tree
from repro.core.topology import torus2d_topology as jtorus
from repro.graph import generators as jgen
from repro_torch.core import baselines
from repro_torch.core.topology import balanced_tree, production_tree
from repro_torch.graph import generators as gen

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _same_graph(g, jg):
    for a in ("senders", "receivers", "edge_weight", "node_weight",
              "offsets"):
        np.testing.assert_array_equal(getattr(g, a), getattr(jg, a))


C2_CASES = [("rmat", lambda m: m.rmat(800, 4800, seed=3)),
            ("grid", lambda m: m.grid2d(24, 24))]


@pytest.mark.parametrize("case", [c[0] for c in C2_CASES])
@pytest.mark.parametrize("which", ["reference_partition", "random"])
def test_bfs_round_cost_equals_reference(case, which):
    mk = dict(C2_CASES)[case]
    g, jg = mk(gen), mk(jgen)
    _same_graph(g, jg)
    topo = c2.machine()
    jtopo = jbalanced_tree((2, 4), level_cost=(6.0, 1.0))
    np.testing.assert_array_equal(topo.F_l, jtopo.F_l)
    part = (jpartition(jg, jtopo, JPartitionConfig(seed=0)).part
            if which == "reference_partition" else
            np.random.default_rng(1).integers(0, topo.k, g.n_nodes))
    srcs = np.random.default_rng(0).integers(0, g.n_nodes, 3)
    for s in srcs:
        want = jc2.bfs_round_cost(jg, jtopo, part, int(s))
        assert c2.bfs_round_cost(g, topo, part, int(s)) == want
        host = c2.host_round_costs(g, topo, part, int(s))
        card = c2.card_round_costs(g, topo, part, int(s), CPU)
        assert card == host
        assert sum(host) == pytest.approx(want, rel=0, abs=0)


def test_spmspv_row_on_the_cpu_checks_every_round():
    g = gen.grid2d(16, 16)
    row = c2.spmspv_row(g, c2.machine(), CPU, host_walk=True)
    for method in ("ours", "cut"):
        assert row["card_rounds"][method] == row["host_rounds"][method]
        assert len(row["card_rounds"][method]) == 3
    assert row["ratio"] == pytest.approx(
        row["frontier_cost_cut"] / row["frontier_cost_ours"])


C34_CASES = [
    ("grid2d_tradeoff", lambda m: m.grid2d(16, 16),
     lambda: balanced_tree((2, 4), F=0.2, level_cost=(1.2, 0.2)),
     lambda: jbalanced_tree((2, 4), F=0.2, level_cost=(1.2, 0.2))),
    ("grid3d_hier", lambda m: m.grid3d(6, 6, 6),
     lambda: production_tree(2, 4, 4), lambda: jproduction_tree(2, 4, 4)),
    ("rmat_hier", lambda m: m.rmat(1000, 6000, seed=2),
     lambda: production_tree(2, 4, 4), lambda: jproduction_tree(2, 4, 4)),
]


@pytest.mark.parametrize("case", [c[0] for c in C34_CASES])
def test_step_time_and_score_all_on_reference_partitions(case):
    _, mk_g, mk_t, mk_jt = next(c for c in C34_CASES if c[0] == case)
    g, jg = mk_g(gen), mk_g(jgen)
    _same_graph(g, jg)
    topo, jtopo = mk_t(), mk_jt()
    parts = {
        "ours": jpartition(jg, jtopo, JPartitionConfig(seed=0)).part,
        "cut": jbaselines.total_cut_partition(jg, jtopo.k),
        "flat_twice": jbaselines.flat_twice_partition(jg, jtopo),
    }
    for method, part in parts.items():
        got = torch_common.spmv_step_time(g, topo, part, CPU)
        want = jcommon.spmv_step_time(jg, jtopo, part)
        assert set(got) == set(want)
        for key, v in want.items():
            assert got[key] == pytest.approx(v, rel=1e-6, abs=1e-9), (
                method, key)
        assert baselines.score_all(g, topo, part, device=CPU) == {
            k: got[k] for k in got if k != "step"}


def test_torus_rows_equal_the_reference():
    """The bench's random part (``default_rng(0)``) scored by the routing
    oracle, single path and multipath: the twin's rows and the reference
    bench's computation give the same numbers."""
    got = {r["name"]: r for r in variants.torus_rows()}
    jg = jgen.rmat(*variants.TORUS_RMAT, seed=4)
    rng = np.random.default_rng(0)
    for mp in (False, True):
        topo = jtorus(4, 4, multipath=mp)
        part = rng.integers(0, topo.k, jg.n_nodes)
        m, _, comm = jreference.makespan_routing_ref(part, jg, topo)
        row = got[f"torus_multipath={mp}"]
        assert row["makespan"] == float(m)
        assert row["max_link"] == float(comm.max())
        assert row["total_link"] == float(comm.sum())
