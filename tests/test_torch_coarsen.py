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
from test_torch_replay import JaxDraws, float_graph, pow2

from repro.core import coarsen as jcoarsen
from repro.graph.generators import grid2d, rmat
from repro_torch import interop
from repro_torch.core import coarsen as tcoarsen

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
