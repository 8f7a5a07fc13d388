"""Port parity for the paper's baselines (``core/baselines.py``): the
cut-refinement rounds, ``total_cut_partition`` and
``flat_twice_partition`` give the reference's assignments exactly when
the reference's ``jax.random`` draws are replayed (``JaxDraws``).

Exactness: ``conn`` is summed in slot order by ``partition_gain`` (its
plain version here) and in the reference's ``segment_sum`` order; the
generated graphs (``grid2d``, ``grid3d``, ``rmat``) carry integer edge and
vertex weights (``from_edges`` gives each edge 1 and adds parallel ones;
contraction adds integers), so both orders give the same float32 sums and
the argmax, the ``gain > 0`` test and the capacity thinning agree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core.topology import balanced_tree as jbalanced_tree
from repro.core.topology import production_tree as jproduction_tree
from repro.graph import generators as jgen
from repro.graph.graph import from_edges as jfrom_edges
from repro_torch import interop
from repro_torch.core import baselines as tb
from test_torch_replay import JaxDraws

torch.set_num_threads(1)


def _graphs():
    return {
        "grid2d_12": lambda: jgen.grid2d(12, 12),
        "grid3d_6": lambda: jgen.grid3d(6, 6, 6),
        "rmat_300": lambda: jgen.rmat(300, 1500, seed=1),
    }


GRAPHS = _graphs()


def _isolated_graph():
    """A ring of 40 vertices plus 10 isolated ones: an isolated vertex's
    conn row is all zero but for the -inf at its own bin, so the argmax
    must pick the first zero, as ``jnp.argmax`` does."""
    u = np.arange(40)
    return jfrom_edges(50, u, (u + 1) % 40)


def _ref_rounds(g, part0, k, rounds, seed, cfg):
    return np.asarray(jb._cut_refine_jit(
        jnp.asarray(part0, jnp.int32), jnp.asarray(g.senders),
        jnp.asarray(g.receivers), jnp.asarray(g.edge_weight),
        jnp.asarray(g.node_weight), jax.random.PRNGKey(seed), k=k,
        rounds=rounds, damping=cfg.damping, imbalance=cfg.imbalance))


@pytest.mark.parametrize("name,k,rounds", [
    ("grid2d_12", 4, 1), ("grid2d_12", 8, 5), ("rmat_300", 4, 16),
    ("grid3d_6", 8, 64), ("isolated", 4, 8), ("isolated", 1, 3)])
def test_cut_refine_rounds_are_the_reference_exactly(name, k, rounds):
    g = _isolated_graph() if name == "isolated" else GRAPHS[name]()
    part0 = np.random.default_rng(3).integers(0, k, g.n_nodes).astype(
        np.int32)
    cfg = tb.CutRefineConfig(rounds=rounds, seed=2)
    want = _ref_rounds(g, part0, k, rounds, cfg.seed, cfg)
    got = tb._cut_refine(torch.as_tensor(part0), interop.graph_from_arrays(g),
                         k, cfg, JaxDraws())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if rounds >= 5:
        assert not np.array_equal(want, part0)   # the rounds moved vertices


def test_isolated_vertex_moves_to_the_first_bin():
    """One round, every gate open: the isolated vertices' candidate is the
    first bin other than their own, with gain 0, so none of them moves; a
    ring vertex whose neighbours sit in another bin moves there."""
    g = _isolated_graph()
    part0 = np.full(50, 2, dtype=np.int32)
    part0[0] = 3                                  # 0's neighbours are in 2
    cfg = tb.CutRefineConfig(rounds=1, damping=1.0, imbalance=100.0)

    class Open:
        def cut_refine(self, seed, n):
            while True:
                yield torch.zeros(2, n)
    got = tb._cut_refine(torch.as_tensor(part0), interop.graph_from_arrays(g),
                         4, cfg, Open()).numpy()
    assert got[0] == 2 and (got[40:] == 2).all()
    want = _ref_rounds(g, part0, 4, 1, 0, cfg)
    # the reference's gates are random; where both open, both agree
    assert want[0] in (2, 3) and (want[40:] == 2).all()


@pytest.mark.parametrize("name,k,seed", [
    ("grid2d_12", 8, 0), ("grid3d_6", 4, 1), ("rmat_300", 8, 0),
    ("rmat_300", 3, 2)])
def test_total_cut_partition_is_the_reference_exactly(name, k, seed):
    g = GRAPHS[name]()
    cfg = tb.CutRefineConfig(seed=seed)
    want = jb.total_cut_partition(g, k, jb.CutRefineConfig(seed=seed),
                                  coarse_factor=4)
    got = tb.total_cut_partition(interop.graph_from_arrays(g), k, cfg,
                                 coarse_factor=4, device="cpu",
                                 draws=JaxDraws())
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and set(np.unique(got)) <= set(range(k))


@pytest.mark.parametrize("name,mk_topo", [
    ("grid2d_12", lambda: jbalanced_tree((2, 4))),
    ("grid3d_6", lambda: jproduction_tree(2, 2, 2)),
    ("rmat_300", lambda: jbalanced_tree((3, 2))),
    ("grid2d_12", lambda: jbalanced_tree((1, 4)))])
def test_flat_twice_partition_is_the_reference_exactly(name, mk_topo):
    g, topo = GRAPHS[name](), mk_topo()
    want = jb.flat_twice_partition(g, topo)
    got = tb.flat_twice_partition(interop.graph_from_arrays(g),
                                  interop.topology_from_arrays(topo),
                                  device="cpu", draws=JaxDraws())
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= set(range(topo.k))


def test_baselines_score_below_random_and_cut_below_makespan_partitioner():
    """The reference's own checks (tests/test_partitioner.py): the cut
    partitioner cuts less than the makespan partitioner, flat-twice beats
    random on the makespan."""
    from repro_torch.core.partitioner import PartitionConfig, partition
    from repro_torch.core.topology import balanced_tree
    from repro_torch.graph.generators import grid2d
    g = grid2d(16, 16)
    topo = balanced_tree((2, 4), level_cost=(8.0, 1.0))
    ours = partition(g, topo, PartitionConfig(seed=0), device="cpu").part
    cut = tb.total_cut_partition(g, topo.k, device="cpu")
    s_ours = tb.score_all(g, topo, ours, device="cpu")
    s_cut = tb.score_all(g, topo, cut, device="cpu")
    assert s_cut["total_cut"] <= s_ours["total_cut"] * 1.5
    assert s_ours["makespan"] <= s_cut["makespan"] * 1.05
    flat = tb.flat_twice_partition(g, topo, device="cpu")
    rand = tb.random_partition(g.n_nodes, topo.k, seed=0)
    assert (tb.score_all(g, topo, flat, device="cpu")["makespan"]
            < tb.score_all(g, topo, rand, device="cpu")["makespan"])


def test_baselines_require_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.core.topology import balanced_tree
    from repro_torch.graph.generators import grid2d
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = grid2d(6, 6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.total_cut_partition(g, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.flat_twice_partition(g, balanced_tree((2, 2)))
