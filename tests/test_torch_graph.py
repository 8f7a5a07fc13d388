"""Port parity: ``repro_torch.graph`` builds the same arrays as
``repro.graph`` (exact equality of every field, across generators and
seeds), and ``interop.graph_from_arrays`` carries a reference graph over
unchanged."""
import numpy as np
import pytest
import torch

from repro.graph import generators as jgen
from repro.graph import graph as jgraph
from repro_torch import interop
from repro_torch.graph import generators as tgen
from repro_torch.graph import graph as tgraph

torch.set_num_threads(1)

FIELDS = ("senders", "receivers", "edge_weight", "node_weight", "offsets")


def assert_same_graph(a, b):
    assert a.n_nodes == b.n_nodes
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


GENERATORS = [
    ("grid2d", lambda m, s: m.grid2d(7, 9, seed=s)),
    ("grid2d_weighted", lambda m, s: m.grid2d(6, 5, seed=s, weighted=True)),
    ("grid3d", lambda m, s: m.grid3d(4, 5, 3)),
    ("rmat", lambda m, s: m.rmat(300, 1200, seed=s)),
    ("random_regular", lambda m, s: m.random_regular(200, 5, seed=s)),
    ("molecule_batch", lambda m, s: m.molecule_batch(6, 9, 14, seed=s)),
    ("weighted_nodes", lambda m, s: m.weighted_nodes(m.rmat(120, 400, seed=s),
                                                     seed=s)),
]


@pytest.mark.parametrize("name,make", GENERATORS, ids=[g[0] for g in GENERATORS])
@pytest.mark.parametrize("seed", [0, 3])
def test_generators_match_reference(name, make, seed):
    assert_same_graph(make(jgen, seed), make(tgen, seed))


@pytest.mark.parametrize("dedup", [True, False])
def test_from_edges_matches_reference(dedup):
    rng = np.random.default_rng(11)
    n = 90
    u, v = rng.integers(0, n, 400), rng.integers(0, n, 400)
    w = rng.random(400).astype(np.float32)
    nw = rng.random(n).astype(np.float32) + 0.5
    assert_same_graph(jgraph.from_edges(n, u, v, w, nw, dedup=dedup),
                      tgraph.from_edges(n, u, v, w, nw, dedup=dedup))


def test_permute_and_subgraph_match_reference():
    g_ref = jgen.rmat(150, 600, seed=4)
    g = tgen.rmat(150, 600, seed=4)
    perm = np.random.default_rng(4).permutation(150)
    assert_same_graph(jgraph.permute(g_ref, perm), tgraph.permute(g, perm))
    nodes = np.sort(np.random.default_rng(5).choice(150, 70, replace=False))
    assert_same_graph(jgraph.subgraph(g_ref, nodes), tgraph.subgraph(g, nodes))


def test_interop_graph_copies_arrays():
    g_ref = jgen.weighted_nodes(jgen.rmat(100, 300, seed=2), seed=2)
    g = interop.graph_from_arrays(g_ref)
    assert isinstance(g, tgraph.Graph)
    assert_same_graph(g_ref, g)
    assert g.senders is not g_ref.senders
    np.testing.assert_array_equal(g.degrees(), g_ref.degrees())
