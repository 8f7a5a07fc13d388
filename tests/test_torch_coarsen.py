"""Port parity for coarsening: the host chain is the reference's exactly;
one device step fed the reference's matching jitter gives the same
contraction (coarse ids, coarse node weights, deduplicated edges); the
whole replayed device chain matches; and the device chain keeps the
coarsening invariants of ``tests/test_device_vcycle.py`` with the port's
own random source."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_replay import JaxDraws, float_graph, pow2

from repro.core import coarsen as jcoarsen
from repro.graph.generators import grid2d, rmat
from repro_torch import interop
from repro_torch.core import coarsen as tcoarsen
from repro_torch.graph.graph import from_edges

torch.set_num_threads(1)

CPU = torch.device("cpu")


def assert_same_levels(ref, port, weight_rtol=0.0):
    assert len(ref) == len(port)
    for lr, lp in zip(ref, port):
        gr, gp = lr.graph, lp.graph
        assert gr.n_nodes == gp.n_nodes
        for f in ("senders", "receivers", "offsets"):
            np.testing.assert_array_equal(getattr(gr, f), getattr(gp, f))
        for f in ("edge_weight", "node_weight"):
            np.testing.assert_allclose(getattr(gr, f), getattr(gp, f),
                                       rtol=weight_rtol, atol=0)
        if lr.fine_to_coarse is None:
            assert lp.fine_to_coarse is None
        else:
            np.testing.assert_array_equal(lr.fine_to_coarse,
                                          lp.fine_to_coarse)


@pytest.mark.parametrize("make,k,seed", [
    (lambda: float_graph(1500, 6000, seed=1), 8, 0),
    (lambda: rmat(800, 3200, seed=2), 4, 3),
    (lambda: grid2d(30, 30), 4, 1)], ids=["float", "rmat", "grid"])
def test_host_coarsen_is_the_reference_exactly(make, k, seed):
    g = make()
    ref = jcoarsen.coarsen(g, k, seed=seed)
    port = tcoarsen.coarsen(interop.graph_from_arrays(g), k, seed=seed)
    assert len(ref) > 1
    assert_same_levels(ref, port)


@pytest.mark.parametrize("seed", [0, 1])
def test_device_step_with_replayed_jitter_matches_reference(seed):
    g = float_graph(1500, 6000, seed=seed)
    n, m = g.n_nodes, g.n_arcs
    n_pad, m_pad = pow2(n), pow2(m)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    ref = jcoarsen._coarsen_step()(
        jnp.asarray(np.pad(g.senders, (0, m_pad - m))),
        jnp.asarray(np.pad(g.receivers, (0, m_pad - m))),
        jnp.asarray(np.pad(g.edge_weight, (0, m_pad - m))),
        jnp.asarray(np.pad(g.node_weight, (0, n_pad - n))),
        jnp.int32(n), jnp.int32(m), key, n_pad=n_pad)
    cid, nc, nw_c, cu_e, cv_e, w_e, m_new = (np.asarray(x) for x in ref)
    st = tcoarsen.coarsen_step(torch.from_numpy(g.senders),
                               torch.from_numpy(g.receivers),
                               torch.from_numpy(g.edge_weight),
                               torch.from_numpy(g.node_weight),
                               JaxDraws(seed), level=0)
    assert int(st.nc) == int(nc) and int(st.m_new) == int(m_new)
    nc, m_new = int(nc), int(m_new)
    assert nc < n
    np.testing.assert_array_equal(st.coarse_id.numpy(), cid[:n])
    np.testing.assert_allclose(st.nw_c.numpy()[:nc], nw_c[:nc], rtol=1e-6)
    np.testing.assert_array_equal(st.cu_e.numpy()[:m_new], cu_e[:m_new])
    np.testing.assert_array_equal(st.cv_e.numpy()[:m_new], cv_e[:m_new])
    np.testing.assert_allclose(st.w_e.numpy()[:m_new], w_e[:m_new],
                               rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 2])
def test_replayed_device_chain_matches_reference(seed):
    g = float_graph(2000, 8000, seed=seed)
    ref = jcoarsen.coarsen_device(g, 8, seed=seed)
    port = tcoarsen.coarsen_device(interop.graph_from_arrays(g), 8,
                                   seed=seed, device="cpu",
                                   draws=JaxDraws(seed))
    assert len(ref) > 2
    assert_same_levels(ref, port, weight_rtol=1e-5)


def _check_coarsen_invariants(levels):
    """``tests/test_device_vcycle.py:_check_coarsen_invariants``."""
    for li in range(1, len(levels)):
        fine, coarse = levels[li - 1], levels[li]
        fg, cg = fine.graph, coarse.graph
        assert cg.n_nodes < fg.n_nodes
        np.testing.assert_allclose(cg.node_weight.sum(),
                                   fg.node_weight.sum(), rtol=1e-5)
        f2c = fine.fine_to_coarse
        assert f2c.shape == (fg.n_nodes,)
        assert f2c.min() >= 0
        assert np.unique(f2c).size == cg.n_nodes
        assert f2c.max() == cg.n_nodes - 1
        half = fg.senders < fg.receivers
        intra = fg.edge_weight[half & (f2c[fg.senders]
                                       == f2c[fg.receivers])].sum()
        fine_tot = fg.edge_weight[half].sum()
        coarse_tot = cg.edge_weight[cg.senders < cg.receivers].sum()
        np.testing.assert_allclose(coarse_tot, fine_tot - intra, rtol=1e-4)
        # CSR invariants of every coarse level (graph.py:17-34)
        assert (np.diff(cg.senders) >= 0).all()
        np.testing.assert_array_equal(np.diff(cg.offsets),
                                      np.bincount(cg.senders,
                                                  minlength=cg.n_nodes))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_coarsening_invariants_with_torch_draws(seed):
    g = interop.graph_from_arrays(float_graph(1500, 6000, seed=seed))
    levels = tcoarsen.coarsen_device(g, k=8, seed=seed, device="cpu")
    assert len(levels) > 1, "coarsening made no progress"
    assert levels[0].graph is g
    _check_coarsen_invariants(levels)
    host = tcoarsen.coarsen(g, k=8, seed=seed)
    assert abs(len(levels) - len(host)) <= 2


def test_coarsen_device_requires_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = interop.graph_from_arrays(float_graph(100, 300))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcoarsen.coarsen_device(g, k=2)


def _reference_round(s, r, w, u, matched):
    """The reference's matching round (``repro/core/coarsen.py:138-151``)
    on unpadded arrays, with its own ``ops.match_keys`` (the Pallas kernel
    in interpret mode): best_arc and prop."""
    from repro.kernels import ops as jops
    n, m = matched.shape[0], w.shape[0]
    s_j, r_j = jnp.asarray(s), jnp.asarray(r)
    elig = (~jnp.asarray(matched)).astype(jnp.float32)
    w_j = jnp.asarray(w)
    mask = elig[s_j] * elig[r_j] * (w_j > 0).astype(jnp.float32)
    keys = jops.match_keys(w_j, jnp.asarray(u), mask, interpret=True)
    seg = jax.ops.segment_max(keys, s_j, num_segments=n)
    at_max = (keys > 0) & (keys >= seg[s_j])
    best = jax.ops.segment_max(jnp.where(at_max, jnp.arange(m, dtype=jnp.int32),
                                         -1), s_j, num_segments=n)
    iota = jnp.arange(n, dtype=jnp.int32)
    prop = jnp.where(best >= 0, r_j[jnp.clip(best, 0)], iota)
    return np.asarray(best), np.asarray(prop)


def _round_case(name):
    """(graph arrays, jitter, matched) of a round: integer weights with no
    jitter (every key tied inside a row), a graph with isolated vertices,
    and float weights with a third of the vertices matched."""
    rng = np.random.default_rng(7)
    if name == "tied":
        g = grid2d(12, 9)
        u = np.zeros(g.n_arcs, np.float32)
        matched = np.zeros(g.n_nodes, bool)
    elif name == "isolated":
        src = rng.integers(0, 60, 150)
        g = from_edges(100, src, (src + rng.integers(1, 40, 150)) % 60,
                       rng.integers(1, 4, 150).astype(np.float32),
                       np.ones(100, np.float32))
        u = rng.random(g.n_arcs).astype(np.float32)
        matched = np.zeros(g.n_nodes, bool)
    else:
        g = float_graph(700, 2500, seed=3)
        u = rng.random(g.n_arcs).astype(np.float32)
        matched = rng.random(g.n_nodes) < 1 / 3
    return g, u, matched


@pytest.mark.parametrize("name", ["tied", "isolated", "partly_matched"])
def test_match_round_plain_is_the_reference_round(name):
    from repro_torch.kernels import match_keys as tmk
    g, u, matched = _round_case(name)
    best_ref, prop_ref = _reference_round(g.senders, g.receivers,
                                          g.edge_weight, u, matched)
    best = tmk.match_round_plain(torch.from_numpy(g.senders),
                                 torch.from_numpy(g.receivers),
                                 torch.from_numpy(g.edge_weight),
                                 torch.from_numpy(u),
                                 torch.from_numpy(matched)).numpy()
    assert best.dtype == np.int32
    live = best_ref >= 0
    np.testing.assert_array_equal(best[live], best_ref[live])
    assert (best[~live] == -1).all()
    if name == "isolated":
        assert (np.bincount(g.senders, minlength=g.n_nodes) == 0).any()
        assert (~live).any()
    prop = np.where(best >= 0, g.receivers[np.maximum(best, 0)],
                    np.arange(g.n_nodes))
    np.testing.assert_array_equal(prop, prop_ref)


F32_MAX = float(np.finfo(np.float32).max)


@settings(max_examples=300, deadline=None)
@given(a=st.floats(min_value=0.0, max_value=F32_MAX, exclude_min=True,
                   width=32),
       b=st.floats(min_value=0.0, max_value=F32_MAX, exclude_min=True,
                   width=32),
       ia=st.integers(0, 2 ** 31 - 1), ib=st.integers(0, 2 ** 31 - 1))
def test_match_round_packed_words_order_as_key_then_arc(a, b, ia, ib):
    """The fused round's 64-bit word ``(key bits << 32) | arc id``
    (``csrc/match_keys.cu``): for positive float32 keys its unsigned order
    is (key, arc id) order, so one atomicMax keeps the largest key and,
    among equal keys, the largest arc id."""
    def word(key, arc):
        bits = int(np.float32(key).view(np.uint32))
        return (bits << 32) | arc
    ka, kb = np.float32(a), np.float32(b)
    assert (word(ka, ia) > word(kb, ib)) == ((ka, ia) > (kb, ib))
    assert (word(ka, ia) == word(kb, ib)) == ((ka, ia) == (kb, ib))
