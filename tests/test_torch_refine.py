"""Port parity for refinement: one dense round and one sparse round (every
candidate mode), fed the reference's own draws, move exactly the same
vertices to the same bins on a float-weighted graph, uniform and
heterogeneous; ``refine_batch`` slot 0 is ``refine``; a replayed
trajectory lands with the reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_replay import JaxDraws, float_graph, round_draws

from repro.core import refine as jrefine
from repro.core.topology import balanced_tree, with_bin_speed
from repro_torch import interop
from repro_torch.core import refine as trefine

torch.set_num_threads(1)


def _setup(branching, speed, seed=0, n=300, m=1200):
    topo = balanced_tree(branching)
    if speed:
        topo = with_bin_speed(topo, np.linspace(1.0, 0.4, topo.k))
    g = float_graph(n, m, seed=seed)
    part = np.random.default_rng(seed).integers(0, topo.k, n).astype(np.int32)
    return g, topo, part


def _jax_arrays(g, topo):
    return dict(
        senders=jnp.asarray(g.senders), receivers=jnp.asarray(g.receivers),
        edge_weight=jnp.asarray(g.edge_weight),
        node_weight=jnp.asarray(g.node_weight),
        subtree=jnp.asarray(topo.subtree), F_l=jnp.asarray(topo.F_l),
        speed=(None if topo.bin_speed is None
               else jnp.asarray(topo.bin_speed)))


CFG = trefine.RefineConfig()
SETUPS = [((2, 4), False), ((2, 2, 2), False), ((2, 4), True)]


@pytest.mark.parametrize("branching,speed", SETUPS)
@pytest.mark.parametrize("temp", [0.25, 0.1, 0.05])
def test_dense_round_moves_match_reference(branching, speed, temp):
    g, topo, part = _setup(branching, speed)
    key = jax.random.PRNGKey(11)
    a = _jax_arrays(g, topo)
    ref_part, ref_moved = jrefine._dense_round(
        jnp.asarray(part), a["senders"], a["receivers"], a["edge_weight"],
        a["node_weight"], a["subtree"], a["F_l"], topo.k, jnp.float32(temp),
        key, CFG.damping, CFG.inflow_slack, a["speed"])
    lv = trefine.level_arrays(interop.graph_from_arrays(g),
                              interop.topology_from_arrays(topo), True,
                              torch.device("cpu"))
    u = torch.from_numpy(round_draws(key, g.n_nodes, dense=True))
    got, moved = trefine._dense_round(torch.from_numpy(part), lv,
                                      np.float32(temp), u, CFG.damping,
                                      CFG.inflow_slack)
    assert int(ref_moved) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_part))
    assert int(moved) == int(ref_moved)


@pytest.mark.parametrize("branching,speed", SETUPS)
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_sparse_round_moves_match_reference(branching, speed, mode):
    g, topo, part = _setup(branching, speed, seed=1)
    key = jax.random.PRNGKey(13 + mode)
    a = _jax_arrays(g, topo)
    offsets = jnp.asarray(g.offsets[:-1], dtype=jnp.int32)
    degrees = jnp.asarray(g.degrees(), dtype=jnp.int32)
    ref_part, ref_moved = jrefine._sparse_round(
        jnp.asarray(part), a["senders"], a["receivers"], a["edge_weight"],
        a["node_weight"], offsets, degrees, a["subtree"], a["F_l"], topo.k,
        jnp.float32(0.1), key, mode, CFG.damping, CFG.inflow_slack,
        a["speed"])
    lv = trefine.level_arrays(interop.graph_from_arrays(g),
                              interop.topology_from_arrays(topo), False,
                              torch.device("cpu"))
    u = torch.from_numpy(round_draws(key, g.n_nodes, dense=False))
    got, moved = trefine._sparse_round(torch.from_numpy(part), lv,
                                       np.float32(0.1), u, mode, CFG.damping,
                                       CFG.inflow_slack)
    assert int(ref_moved) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_part))
    assert int(moved) == int(ref_moved)


@pytest.mark.parametrize("dense", [True, False])
def test_refine_batch_slot0_is_refine(dense):
    g, topo, part = _setup((2, 4), False, seed=2)
    g, topo = interop.graph_from_arrays(g), interop.topology_from_arrays(topo)
    threshold = 10**9 if dense else 0
    cfg = trefine.RefineConfig(rounds=12, dense_threshold=threshold, seed=4)
    rng = np.random.default_rng(2)
    parts = np.stack([part, rng.integers(0, topo.k, g.n_nodes)])
    bp, bm, stats = trefine.refine_batch(g, topo, parts, cfg, device="cpu")
    p0, m0, s0 = trefine.refine(g, topo, part, cfg, device="cpu")
    np.testing.assert_array_equal(bp[0], p0)
    assert bm[0] == m0
    np.testing.assert_array_equal(stats.makespan[0], s0.makespan)
    assert stats.moved.shape == (2, 12) and stats.moved.dtype == np.int32
    assert m0 <= float(s0.makespan.min()) + 1e-6
    np.testing.assert_array_equal(part, parts[0])      # input not mutated


@pytest.mark.parametrize("dense", [True, False])
def test_replayed_refine_lands_with_reference(dense):
    """Whole trajectories with the reference's draws: the best makespan
    agrees to float rounding and at most a few rounds' moves differ (a
    near-tie in a gain or a cap ratio can flip one vertex's move)."""
    g, topo, part = _setup((2, 2, 2), True, seed=3)
    threshold = 10**9 if dense else 0
    jcfg = jrefine.RefineConfig(rounds=24, dense_threshold=threshold, seed=6)
    jp, jm, jstats = jrefine.refine(g, topo, part, jcfg)
    tp, tm, tstats = trefine.refine(
        interop.graph_from_arrays(g), interop.topology_from_arrays(topo), part,
        interop.partition_config_from(jcfg), device="cpu", draws=JaxDraws())
    np.testing.assert_allclose(tm, jm, rtol=1e-3)
    np.testing.assert_allclose(tstats.makespan, jstats.makespan, rtol=2e-2)
    assert (tp != jp).mean() <= 0.02


def _dense_gains_both(g, topo, part, temp):
    """Dense-round gain matrices of the reference and of the port."""
    from repro.core import objective as jobj
    from repro.kernels import ops as jops
    a = _jax_arrays(g, topo)
    p = jnp.asarray(part)
    k = topo.k
    comp = jobj.comp_loads(p, a["node_weight"], k)
    W = jobj.quotient_matrix(p, a["senders"], a["receivers"],
                             a["edge_weight"], k)
    gc, gl = jobj.load_gradients(comp, jobj.link_loads_tree(W, a["subtree"]),
                                 a["F_l"], jnp.float32(temp), a["speed"])
    pi = jrefine.price_matrix(gl, a["subtree"])
    conn = jops.partition_gain(p, a["senders"], a["receivers"],
                               a["edge_weight"], k)
    ref = (jnp.sum(conn * pi[p], axis=1)[:, None] - conn @ pi.T
           + a["node_weight"][:, None] * (gc[p][:, None] - gc[None, :]))
    lv = trefine.level_arrays(interop.graph_from_arrays(g),
                              interop.topology_from_arrays(topo), True,
                              torch.device("cpu"))
    pt = torch.from_numpy(part)
    _, gc2, pi2 = trefine._scores(pt, lv, np.float32(temp))
    conn2 = trefine.kops.partition_gain(pt, lv.ell_idx, lv.ell_w, k)
    port = ((conn2 * pi2[pt]).sum(1)[:, None] - conn2 @ pi2.T
            + lv.node_weight[:, None] * (gc2[pt][:, None] - gc2[None, :]))
    own = np.arange(len(part)), part
    ref, port = np.array(ref), port.numpy()
    ref[own] = port[own] = -np.inf
    return ref, port


@pytest.mark.parametrize("branching,speed", SETUPS)
def test_dense_round_at_min_temperature_differs_only_at_near_ties(branching,
                                                                  speed):
    """At temp 0.02 the leaf-link prices fall below float32 resolution, so
    bins inside one subtree have bitwise-equal price rows: the port's gain
    ``cur - new`` for them is exactly 0 and the tiny bin-price term decides,
    while the reference's matmul leaves a +-1 ulp (2.4e-7) residue that
    decides instead. Moves may differ only at such near-ties."""
    temp = 0.02
    g, topo, part = _setup(branching, speed)
    key = jax.random.PRNGKey(11)
    a = _jax_arrays(g, topo)
    ref_part, _ = jrefine._dense_round(
        jnp.asarray(part), a["senders"], a["receivers"], a["edge_weight"],
        a["node_weight"], a["subtree"], a["F_l"], topo.k, jnp.float32(temp),
        key, CFG.damping, CFG.inflow_slack, a["speed"])
    lv = trefine.level_arrays(interop.graph_from_arrays(g),
                              interop.topology_from_arrays(topo), True,
                              torch.device("cpu"))
    u = torch.from_numpy(round_draws(key, g.n_nodes, dense=True))
    got, _ = trefine._dense_round(torch.from_numpy(part), lv, np.float32(temp),
                                  u, CFG.damping, CFG.inflow_slack)
    ref_part, got = np.asarray(ref_part), got.numpy()
    differ = np.nonzero(ref_part != got)[0]
    assert differ.size <= 0.05 * part.size
    G_ref, G_port = _dense_gains_both(g, topo, part, temp)
    for v in differ:
        c_ref, c_port = G_ref[v].argmax(), G_port[v].argmax()
        assert abs(G_ref[v, c_ref] - G_ref[v, c_port]) <= 1e-6, v
        assert abs(G_ref[v].max() - G_port[v].max()) <= 1e-6, v


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("rounds", [0, 1, 7])
def test_trajectory_of_r_rounds_makes_r_plus_one_link_load_calls(
        dense, rounds, monkeypatch):
    """The start's breakdown and each round's hand their comm to the next
    round's scores: one ``quotient_link_loads`` call per round, plus one."""
    g, topo, part = _setup((2, 4), False, seed=2)
    calls = []
    for name in ("link_loads", "link_loads_and_quotient"):
        orig = getattr(trefine.kops, name)

        def counted(*args, _orig=orig, **kw):
            calls.append(1)
            return _orig(*args, **kw)
        monkeypatch.setattr(trefine.kops, name, counted)
    cfg = trefine.RefineConfig(rounds=rounds,
                               dense_threshold=10**9 if dense else 0)
    trefine.refine(interop.graph_from_arrays(g),
                   interop.topology_from_arrays(topo), part, cfg,
                   device="cpu")
    assert len(calls) == rounds + 1


@pytest.mark.parametrize("dense,mode", [(True, None), (False, 0),
                                        (False, 1), (False, 2)])
def test_round_with_the_carried_comm_is_the_round_that_computes_it(dense,
                                                                   mode):
    """A round handed the breakdown's comm of its part moves exactly as the
    round that calls the kernel itself."""
    g, topo, part = _setup((2, 2, 2), True, seed=4)
    lv = trefine.level_arrays(interop.graph_from_arrays(g),
                              interop.topology_from_arrays(topo), dense,
                              torch.device("cpu"))
    pt = torch.from_numpy(part)
    comm = trefine._makespan(pt, lv).comm
    u = torch.from_numpy(np.random.default_rng(5).random(
        (3, g.n_nodes)).astype(np.float32))
    temp = np.float32(0.1)
    if dense:
        runs = [trefine._dense_round(pt, lv, temp, u, CFG.damping,
                                     CFG.inflow_slack, c)
                for c in (None, comm)]
    else:
        runs = [trefine._sparse_round(pt, lv, temp, u, mode, CFG.damping,
                                      CFG.inflow_slack, c)
                for c in (None, comm)]
    (p0, m0), (p1, m1) = runs
    assert int(m0) > 0
    assert torch.equal(p0, p1) and int(m0) == int(m1)
    for a, b in zip(trefine._scores(pt, lv, temp),
                    trefine._scores(pt, lv, temp, comm)):
        assert torch.equal(a, b)
