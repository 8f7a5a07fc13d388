"""Port parity for the tree objective: every function of
``repro_torch.core.objective`` against ``repro.core.objective`` on the same
numpy inputs (rtol 1e-5), ``makespan_tree`` (comm through the
``quotient_link_loads`` plain version) against the path-walking oracle, and
the ``segment_max`` empty-segment identity the two-pass argmaxes need."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import objective as jobj
from repro.core.reference import makespan_ref as jmakespan_ref
from repro.core.topology import balanced_tree, with_bin_speed
from repro.graph.generators import rmat
from repro_torch import interop
from repro_torch.core import objective as tobj
from repro_torch.core.reference import makespan_ref

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(branching, seed, speed):
    topo = balanced_tree(branching)
    if speed:
        topo = with_bin_speed(
            topo, np.random.default_rng(seed).uniform(0.25, 1.0, topo.k))
    g = rmat(150, 600, seed=seed)
    rng = np.random.default_rng(seed)
    # symmetric float weights: both arcs of an edge carry the same weight
    lo = np.minimum(g.senders, g.receivers).astype(np.int64)
    hi = np.maximum(g.senders, g.receivers).astype(np.int64)
    w = (np.sin(lo * 7.0 + hi * 13.0) * 0.5 + 1.0).astype(np.float32)
    nw = rng.random(g.n_nodes).astype(np.float32) + 0.5
    part = rng.integers(0, topo.k, g.n_nodes).astype(np.int32)
    return topo, g, w, nw, part


CASES = [((2, 4), 0, False), ((2, 2, 2), 1, False), ((2, 4), 2, True),
         ((3, 3), 3, True)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("branching,seed,speed", CASES)
def test_objective_functions_match_reference(branching, seed, speed):
    topo, g, w, nw, part = _case(branching, seed, speed)
    k = topo.k
    sp = None if topo.bin_speed is None else topo.bin_speed
    j_sp = None if sp is None else jnp.asarray(sp)
    t_sp = None if sp is None else _t(sp)

    comp = tobj.comp_loads(_t(part), _t(nw), k, t_sp)
    np.testing.assert_allclose(comp.numpy(), np.asarray(
        jobj.comp_loads(jnp.asarray(part), jnp.asarray(nw), k, j_sp)), **TOL)

    W = tobj.quotient_matrix(_t(part), _t(g.senders), _t(g.receivers), _t(w),
                             k)
    jW = jobj.quotient_matrix(jnp.asarray(part), jnp.asarray(g.senders),
                              jnp.asarray(g.receivers), jnp.asarray(w), k)
    np.testing.assert_allclose(W.numpy(), np.asarray(jW), **TOL)

    comm = tobj.link_loads_tree(W, _t(topo.subtree))
    jcomm = jobj.link_loads_tree(jW, jnp.asarray(topo.subtree))
    np.testing.assert_allclose(comm.numpy(), np.asarray(jcomm), **TOL)

    np.testing.assert_allclose(float(tobj.total_cut(W)),
                               float(jobj.total_cut(jW)), **TOL)

    F = _t(topo.F_l)
    br = tobj.makespan_from_parts(comp, comm, F)
    jbr = jobj.makespan_from_parts(jnp.asarray(comp.numpy()), jcomm,
                                   jnp.asarray(topo.F_l))
    for f in ("makespan", "comp_max", "comm_max"):
        np.testing.assert_allclose(float(getattr(br, f)),
                                   float(getattr(jbr, f)), **TOL)

    raw = tobj.comp_loads(_t(part), _t(nw), k)
    for temp in (0.25, 0.05, 0.02):   # the refinement anneals down to 0.02
        gc, gl = tobj.load_gradients(raw, comm, F, np.float32(temp), t_sp)
        jgc, jgl = jobj.load_gradients(jnp.asarray(raw.numpy()), jcomm,
                                       jnp.asarray(topo.F_l),
                                       jnp.float32(temp), j_sp)
        np.testing.assert_allclose(gc.numpy(), np.asarray(jgc), **TOL)
        np.testing.assert_allclose(gl.numpy(), np.asarray(jgl), **TOL)
        sc = tobj.soft_cost(raw, comm, F, np.float32(temp), t_sp)
        jsc = jobj.soft_cost(jnp.asarray(raw.numpy()), jcomm,
                             jnp.asarray(topo.F_l), jnp.float32(temp), j_sp)
        np.testing.assert_allclose(float(sc), float(jsc), rtol=1e-5)


@pytest.mark.parametrize("branching,seed,speed", CASES)
def test_makespan_tree_matches_reference_and_oracle(branching, seed, speed):
    topo, g, _, nw, part = _case(branching, seed, speed)
    g = g.__class__(g.n_nodes, g.senders, g.receivers, g.edge_weight, nw,
                    g.offsets)
    br = tobj.makespan_tree(part, g.senders, g.receivers, g.edge_weight,
                            g.node_weight, topo.subtree, topo.F_l, k=topo.k,
                            speed=topo.bin_speed, device="cpu")
    jsp = None if topo.bin_speed is None else jnp.asarray(topo.bin_speed)
    jbr = jobj.makespan_tree(jnp.asarray(part), jnp.asarray(g.senders),
                             jnp.asarray(g.receivers),
                             jnp.asarray(g.edge_weight), jnp.asarray(nw),
                             jnp.asarray(topo.subtree), jnp.asarray(topo.F_l),
                             k=topo.k, speed=jsp)
    for f in MAKESPAN_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(br, f)),
                                   np.asarray(getattr(jbr, f)), **TOL)
    # the port's own oracle copy and the reference's agree with it
    port_g = interop.graph_from_arrays(g)
    port_t = interop.topology_from_arrays(topo)
    m_ref, comp_ref, comm_ref = makespan_ref(part, port_g, port_t)
    assert (m_ref, list(comp_ref), list(comm_ref)) == _listed(
        jmakespan_ref(part, g, topo))
    np.testing.assert_allclose(br.comp.numpy(), comp_ref, rtol=1e-5)
    np.testing.assert_allclose(br.comm.numpy(), comm_ref, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(float(br.makespan), m_ref, rtol=1e-5)


MAKESPAN_FIELDS = ("makespan", "comp", "comm", "comp_max", "comm_max")


def _listed(t):
    return (t[0], list(t[1]), list(t[2]))


def test_makespan_tree_requires_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = balanced_tree((2, 2))
    g = rmat(20, 40, seed=0)
    part = np.zeros(20, dtype=np.int32)
    args = (part, g.senders, g.receivers, g.edge_weight, g.node_weight,
            topo.subtree, topo.F_l)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tobj.makespan_tree(*args, k=topo.k)
    assert float(tobj.makespan_tree(*args, k=topo.k, device="cpu")
                 .comp_max) == 20.0


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_max_fills_empty_segments_like_jax(dtype):
    data = np.array([3, -7, 5, 2], dtype=dtype)
    seg = np.array([0, 0, 2, 2])
    got = tobj.segment_max(torch.from_numpy(data), torch.from_numpy(seg), 4)
    want = np.asarray(jax.ops.segment_max(jnp.asarray(data), jnp.asarray(seg),
                                          num_segments=4))
    np.testing.assert_array_equal(got.numpy(), want)
    # empty segments hold the identity: -inf / the int minimum
    assert got[1] == want[1] and got[3] == want[3]
    if dtype == np.float32:
        assert np.isneginf(want[1])
    else:
        assert want[1] == np.iinfo(np.int32).min


SCORE_TOL = dict(rtol=1e-6)


@pytest.mark.parametrize("branching,seed,speed", CASES)
def test_comm_volumes_and_quotient_match_reference(branching, seed, speed):
    topo, g, w, nw, part = _case(branching, seed, speed)
    k = topo.k
    cvol = tobj.comm_volumes(_t(part), _t(g.senders), _t(g.receivers), _t(nw),
                             k)
    jcvol = jobj.comm_volumes(jnp.asarray(part), jnp.asarray(g.senders),
                              jnp.asarray(g.receivers), jnp.asarray(nw), k)
    np.testing.assert_allclose(cvol.numpy(), np.asarray(jcvol), **SCORE_TOL)
    W = tobj.quotient_matrix(_t(part), _t(g.senders), _t(g.receivers), _t(w),
                             k)
    jW = jobj.quotient_matrix(jnp.asarray(part), jnp.asarray(g.senders),
                              jnp.asarray(g.receivers), jnp.asarray(w), k)
    np.testing.assert_allclose(W.numpy(), np.asarray(jW), **SCORE_TOL)


def test_comm_volumes_counts_foreign_blocks_once():
    # path 0-1-2-3 with 0,1 in block 0 and 2,3 in block 1; an isolated 4
    s = np.array([0, 1, 1, 2, 2, 3], np.int32)
    r = np.array([1, 0, 2, 1, 3, 2], np.int32)
    part = np.array([0, 0, 1, 1, 2], np.int32)
    nw = np.array([1, 2, 3, 4, 5], np.float32)
    got = tobj.comm_volumes(_t(part), _t(s), _t(r), _t(nw), 3)
    np.testing.assert_array_equal(got.numpy(), [2.0, 3.0, 0.0])


@pytest.mark.parametrize("branching,seed,speed", CASES)
def test_score_all_matches_reference(branching, seed, speed):
    from repro.core import baselines as jbaselines
    from repro_torch.core import baselines as tbaselines
    topo, g, w, nw, part = _case(branching, seed, speed)
    g = g.__class__(g.n_nodes, g.senders, g.receivers, w, nw, g.offsets)
    want = jbaselines.score_all(g, topo, part)
    got = tbaselines.score_all(interop.graph_from_arrays(g),
                               interop.topology_from_arrays(topo), part,
                               device="cpu")
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **SCORE_TOL)


# ---------------------------------------------------------------------------
# The routing objective and the batched scorers, on the reference tests'
# inputs (tests/test_objective.py)
# ---------------------------------------------------------------------------

def _rand_graph(n=60, m=180, seed=0):
    from repro.graph.generators import weighted_nodes
    return weighted_nodes(rmat(n, m, seed=seed), seed=seed)


def test_quotient_and_tree_loads_match_reference_on_its_inputs():
    from repro.core import reference as jref
    from repro.core.topology import production_tree
    g = _rand_graph(seed=7)
    topo = production_tree(2, 2, 4)
    part = np.random.default_rng(7).integers(0, topo.k, g.n_nodes)
    W = tobj.quotient_matrix(_t(part), _t(g.senders), _t(g.receivers),
                             _t(g.edge_weight), topo.k)
    jW = jobj.quotient_matrix(jnp.asarray(part, jnp.int32),
                              jnp.asarray(g.senders), jnp.asarray(g.receivers),
                              jnp.asarray(g.edge_weight), topo.k)
    np.testing.assert_allclose(W.numpy(), np.asarray(jW), **TOL)
    comm = tobj.link_loads_tree(W, _t(topo.subtree))
    np.testing.assert_allclose(
        comm.numpy(), np.asarray(jobj.link_loads_tree(
            jW, jnp.asarray(topo.subtree))), **TOL)
    _, _, comm_ref = jref.makespan_ref(part, g, topo)
    np.testing.assert_allclose(comm.numpy(), comm_ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(tobj.total_cut(W)),
                               jref.total_cut_ref(part, g), rtol=1e-5)


@pytest.mark.parametrize("multipath", [False, True])
def test_makespan_routing_matches_reference_and_oracle(multipath):
    from repro.core import reference as jref
    from repro.core.topology import torus2d_topology
    g = _rand_graph(40, 120, seed=5)
    rng = np.random.default_rng(5)
    if multipath:
        rng.integers(0, 9, g.n_nodes)      # the reference test's second draw
    topo = torus2d_topology(3, 3, multipath=multipath)
    part = rng.integers(0, topo.k, g.n_nodes)
    br = tobj.makespan_routing(part, g.senders, g.receivers, g.edge_weight,
                               g.node_weight, topo.path_incidence, topo.F_l,
                               k=topo.k, device="cpu")
    jbr = jobj.makespan_routing(
        jnp.asarray(part, jnp.int32), jnp.asarray(g.senders),
        jnp.asarray(g.receivers), jnp.asarray(g.edge_weight),
        jnp.asarray(g.node_weight), jnp.asarray(topo.path_incidence),
        jnp.asarray(topo.F_l), k=topo.k)
    for f in MAKESPAN_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(br, f)),
                                   np.asarray(getattr(jbr, f)), **TOL)
    m_ref, comp_ref, comm_ref = jref.makespan_routing_ref(part, g, topo)
    # and the port's own copy of the oracle, on the port's topology
    port_topo = interop.topology_from_arrays(topo)
    from repro_torch.core.reference import makespan_routing_ref
    m2, _, comm2 = makespan_routing_ref(part, interop.graph_from_arrays(g),
                                        port_topo)
    assert m2 == m_ref and np.array_equal(comm2, comm_ref)
    np.testing.assert_allclose(br.comm.numpy(), comm_ref, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(br.comp.numpy(), comp_ref, rtol=1e-5)
    np.testing.assert_allclose(float(br.makespan), m_ref, rtol=1e-5)
    loads = tobj.link_loads_routing(
        tobj.quotient_matrix(_t(part), _t(g.senders), _t(g.receivers),
                             _t(g.edge_weight), topo.k),
        _t(topo.path_incidence))
    np.testing.assert_allclose(loads.numpy(), np.asarray(jbr.comm), **TOL)


def _sym(rng, d, lo=0.0, hi=5.0, keep=None):
    T = rng.uniform(lo, hi, (d, d))
    if keep is not None:
        T = T * (rng.uniform(0, 1, (d, d)) > keep)
    T = np.triu(T, 1)
    return T + T.T


def test_permutation_link_loads_matches_reference():
    from repro.core.topology import production_tree
    rng = np.random.default_rng(11)
    topo = production_tree(2, 2, 2)
    T = _sym(rng, topo.k)
    for _ in range(3):
        d2b = rng.permutation(topo.k)
        got = tobj.permutation_link_loads(_t(T.astype(np.float32)),
                                          _t(topo.subtree), _t(d2b))
        want = jobj.permutation_link_loads(
            jnp.asarray(T, jnp.float32), jnp.asarray(topo.subtree),
            jnp.asarray(d2b, jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
        # the quotient path on the relabelled traffic
        W = np.zeros_like(T)
        W[np.ix_(d2b, d2b)] = T
        ref = tobj.link_loads_tree(_t(W.astype(np.float32)), _t(topo.subtree))
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-4)


def test_permutation_link_loads_batch_matches_reference():
    rng = np.random.default_rng(12)
    topo = balanced_tree((2, 2, 2), level_cost=(4.0, 2.0, 1.0))
    d = topo.k
    T = _sym(rng, d, 0.0, 3.0, keep=0.4)
    cands = np.stack([rng.permutation(d) for _ in range(5)])
    iu = np.triu_indices(d, 1)
    w = T[iu]
    nz = w > 0
    args = (iu[0][nz], iu[1][nz], w[nz].astype(np.float32), topo.lca_table(),
            topo.subtree, topo.node_subtree_indicator())
    got = tobj.permutation_link_loads_batch(
        _t(cands), *(_t(a) for a in args), k=topo.k, n_nodes=topo.n_nodes)
    want = jobj.permutation_link_loads_batch(
        jnp.asarray(cands, jnp.int32), *(jnp.asarray(a) for a in args),
        k=topo.k, n_nodes=topo.n_nodes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    for c, row in zip(cands, got.numpy()):
        one = tobj.permutation_link_loads(_t(T.astype(np.float32)),
                                          _t(topo.subtree), _t(c))
        np.testing.assert_allclose(row, one.numpy(), rtol=1e-5, atol=1e-4)


def test_makespan_tree_batch_matches_reference_and_per_candidate():
    g = _rand_graph(30, 90, seed=13)
    topo = balanced_tree((2, 3))
    rng = np.random.default_rng(13)
    parts = rng.integers(0, topo.k, (4, g.n_nodes))
    args = (g.senders, g.receivers, g.edge_weight, g.node_weight,
            topo.subtree, topo.F_l)
    br = tobj.makespan_tree_batch(parts, *args, k=topo.k, device="cpu")
    jbr = jobj.makespan_tree_batch(jnp.asarray(parts, jnp.int32),
                                   *(jnp.asarray(a) for a in args), k=topo.k)
    assert br.comm.shape == (4, topo.n_links)
    for f in MAKESPAN_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(br, f)),
                                   np.asarray(getattr(jbr, f)), rtol=1e-5,
                                   atol=1e-4)
    for i in range(4):
        one = tobj.makespan_tree(parts[i], *args, k=topo.k, device="cpu")
        np.testing.assert_allclose(float(br.makespan[i]), float(one.makespan),
                                   rtol=1e-5)
