"""Port parity for the partition-sharded embedding table: access
statistics, capacity fallback and repair, shard plans and the permuted
table's lookups against ``repro/embed/sharded_table.py`` on the same numpy
inputs. Integer outputs are held exactly. ``plan_shards`` end to end is
exact where the replayed refinement trajectories agree; where they split,
the test names the near-tie rows where it happens and holds the
partitioner's makespan to 1.05x of the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_refine import CFG, _dense_gains_both, _jax_arrays
from test_torch_replay import JaxDraws, round_draws

from repro.core import refine as jrefine
from repro.core.initial import initial_partition as jinitial_partition
from repro.core.machine import MachineSpec as JMachineSpec
from repro.core.partitioner import PartitionConfig as JConfig
from repro.core.partitioner import partition as jpartition
from repro.embed import sharded_table as jst
from repro.graph.graph import from_edges as jfrom_edges
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.core import refine as trefine
from repro_torch.core.partitioner import PartitionConfig, partition
from repro_torch.embed import sharded_table as tst
from repro_torch.graph.graph import from_edges as tfrom_edges
from repro_torch.kernels import bag_combine, ops

torch.set_num_threads(1)
MACHINE = "tpu-mixed-32"


def _zipf_stream(v, batch, hist, n_batches, seed=0, a=1.1):
    """The reference tests' Zipf bag stream (``tests/test_embed.py``)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, v + 1, dtype=np.float64)
    probs = ranks ** (-a)
    probs /= probs.sum()
    out = []
    for _ in range(n_batches):
        ids = rng.choice(v, size=(batch, hist), p=probs)
        drop = rng.random(ids.shape) < 0.2
        out.append(np.where(drop, -1, ids).astype(np.int32))
    return out


def _both_stats(v, stream, max_clique=16):
    js, ts = jst.RowAccessStats(v, max_clique), tst.RowAccessStats(v, max_clique)
    for ids in stream:
        js.record(ids)
        ts.record(ids)
    return js, ts


def _graph_arrays(g):
    return (g.senders, g.receivers, g.edge_weight, g.node_weight, g.offsets)


@pytest.mark.parametrize("case", ["zipf", "dup_ids", "points", "clique4",
                                  "empty_bags"])
def test_row_access_stats_match_reference(case):
    v = 300
    stream = _zipf_stream(v, 16, 8, 6)
    clique = 16
    if case == "dup_ids":        # repeated ids inside one bag count once
        stream = [np.random.default_rng(1).integers(-1, 20, (32, 12))]
    elif case == "points":       # [N] point lookups: counts, no pairs
        stream = [np.arange(v), np.arange(0, v, 3)]
    elif case == "clique4":      # cliques capped at the 4 smallest ids
        clique = 4
    elif case == "empty_bags":
        stream = [np.full((5, 6), -1, np.int32), stream[0]]
    js, ts = _both_stats(v, stream, clique)
    np.testing.assert_array_equal(ts.counts, js.counts)
    assert (ts.n_pairs, ts.n_batches) == (js.n_pairs, js.n_batches)
    ju, jv, jw = js.pair_arrays()
    tu, tv, tw = ts.pair_arrays()
    assert tu.dtype == np.int64 and tw.dtype == np.float64
    # the same pair counts; order is the port's key order
    ref = sorted(zip(ju.tolist(), jv.tolist(), jw.tolist()))
    assert sorted(zip(tu.tolist(), tv.tolist(), tw.tolist())) == ref
    if ju.size:
        nw = np.maximum(js.counts, 1.0).astype(np.float32)
        a = jfrom_edges(v, ju, jv, jw.astype(np.float32), nw)
        b = tfrom_edges(v, tu, tv, tw.astype(np.float32), nw)
        for x, y in zip(_graph_arrays(a), _graph_arrays(b)):
            np.testing.assert_array_equal(x, y)


def test_row_access_stats_reject_bad_ids():
    ts = tst.RowAccessStats(10)
    with pytest.raises(ValueError, match="outside table"):
        ts.record(np.array([[1, 10]]))
    with pytest.raises(ValueError, match="ids must be"):
        ts.record(np.zeros((2, 2, 2), np.int32))
    with pytest.raises(ValueError, match="n_rows"):
        tst.RowAccessStats(0)


def _topos(machine):
    j = JMachineSpec.preset(machine).tree()
    return j, interop.topology_from_arrays(j)


@pytest.mark.parametrize("machine", ["tpu-mixed-32", "gpu-superpod"])
@pytest.mark.parametrize("n", [40, 1001])
def test_capacity_blocks_match_reference(machine, n):
    jt, tt = _topos(machine)
    nw = np.random.default_rng(n).random(n) + 0.01
    np.testing.assert_array_equal(tst._capacity_blocks(nw, tt),
                                  jst._capacity_blocks(nw, jt))


def _skewed_part(n, k, seed):
    """Most rows in a few bins, so the repair has to move many of them;
    integer access counts with many ties, so the tie order matters."""
    rng = np.random.default_rng(seed)
    p = rng.random(k) ** 6
    part = rng.choice(k, size=n, p=p / p.sum())
    counts = rng.integers(0, 5, n).astype(np.float64)
    return part, counts


@pytest.mark.parametrize("machine", ["tpu-mixed-32", "gpu-superpod"])
@pytest.mark.parametrize("n,slack", [(300, 0.2), (2000, 0.05),
                                     (20_000, 0.2)])
def test_repair_capacity_is_the_reference_exactly(machine, n, slack):
    jt, tt = _topos(machine)
    part, counts = _skewed_part(n, jt.k, seed=n)
    want = jst._repair_capacity(part, counts, jt, slack)
    got = tst._repair_capacity(part, counts, tt, slack)
    assert (got != part).sum() > 0.1 * n          # many moves were needed
    np.testing.assert_array_equal(got, want)


def test_repair_capacity_leaves_small_or_balanced_parts():
    jt, tt = _topos("gpu-superpod")
    part = np.arange(30) % 64                     # fewer rows than bins
    np.testing.assert_array_equal(
        tst._repair_capacity(part, np.ones(30), tt, 0.2), part)
    bal = np.arange(6400) % 64
    np.testing.assert_array_equal(
        tst._repair_capacity(bal, np.ones(6400), tt, 0.2), bal)


def _assert_plans_equal(got, want):
    for f in ("row_to_device", "order", "perm", "offsets"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert got.n_devices == want.n_devices and got.machine == want.machine
    np.testing.assert_allclose(got.makespan, want.makespan, rtol=1e-6)


@pytest.mark.parametrize("n_rows,n_devices", [(17, 3), (5, 1), (64, 8)])
def test_identity_plan_and_plan_record(n_rows, n_devices):
    want = jst.identity_plan(n_rows, n_devices)
    got = tst.identity_plan(n_rows, n_devices)
    got.check()
    _assert_plans_equal(got, want)
    _assert_plans_equal(interop.shard_plan_from(want), want)
    np.testing.assert_array_equal(got.shard_sizes, want.shard_sizes)
    assert got.n_rows == want.n_rows


def test_shard_plan_check_catches_broken_plans():
    good = tst.identity_plan(8, 2)
    good.check()
    bad = dict(row_to_device=good.row_to_device, n_devices=2,
               order=good.order, perm=good.perm, offsets=good.offsets,
               makespan=0.0)
    for field, value, msg in (
            ("perm", np.array([0, 0, 2, 3, 4, 5, 6, 7]), "not a permutation"),
            ("order", good.order[::-1].copy(), "inverse"),
            ("row_to_device", good.row_to_device[::-1].copy(), "contiguous"),
            ("offsets", np.array([0, 3, 8]), "offsets")):
        with pytest.raises(AssertionError, match=msg):
            tst.ShardPlan(**{**bad, field: value}).check()


def _plan_both(v, seed, machine=MACHINE, n_devices=None):
    js, ts = _both_stats(v, _zipf_stream(v, 16, 8, 6, seed=0))
    want = jst.plan_shards(js, machine=machine, n_devices=n_devices,
                           seed=seed)
    got = tst.plan_shards(ts, machine=machine, n_devices=n_devices,
                          seed=seed, draws=JaxDraws(seed), device="cpu")
    got.check()
    return js, want, got


@pytest.mark.parametrize("v,seed", [(600, 2), (600, 3)])
def test_plan_shards_is_the_reference_where_trajectories_agree(v, seed):
    _, want, got = _plan_both(v, seed)
    _assert_plans_equal(got, want)


def test_plan_shards_degenerate_inputs_match_reference():
    for stream, kw in (([np.arange(40)], dict(n_devices=4)),
                       (_zipf_stream(20, 4, 6, 2), dict(machine=MACHINE))):
        n = 40 if "n_devices" in kw else 20
        js, ts = _both_stats(n, stream)
        want = jst.plan_shards(js, **kw)
        got = tst.plan_shards(ts, draws=JaxDraws(0), device="cpu", **kw)
        got.check()
        _assert_plans_equal(got, want)


def _first_split(g, topo, seed):
    """Replay the single-level dense refinement of ``plan_shards`` round by
    round from the common initial partition, each round from the
    reference's state; return (round, rows, gain gaps, row gain scales) of
    the first round whose moves differ, or None."""
    a = _jax_arrays(g, topo)
    lv = trefine.level_arrays(interop.graph_from_arrays(g),
                              interop.topology_from_arrays(topo), True,
                              torch.device("cpu"))
    part = np.asarray(jinitial_partition(g, topo, seed=seed), np.int32)
    key = jax.random.PRNGKey(seed)
    temp = np.float32(CFG.temp0)
    for r in range(CFG.rounds):
        key, sub = jax.random.split(key)
        ref, _ = jrefine._dense_round(
            jnp.asarray(part), a["senders"], a["receivers"], a["edge_weight"],
            a["node_weight"], a["subtree"], a["F_l"], topo.k,
            jnp.float32(temp), sub, CFG.damping, CFG.inflow_slack, a["speed"])
        got, _ = trefine._dense_round(
            torch.from_numpy(part), lv, temp,
            torch.from_numpy(round_draws(sub, g.n_nodes, True)), CFG.damping,
            CFG.inflow_slack)
        ref, got = np.asarray(ref), got.numpy()
        rows = np.nonzero(ref != got)[0]
        if rows.size:
            G_ref, G_port = _dense_gains_both(g, topo, part, temp)
            gaps = [abs(G_ref[v, G_ref[v].argmax()] - G_ref[v, G_port[v].argmax()])
                    for v in rows]
            scale = [np.abs(G_ref[v][np.isfinite(G_ref[v])]).max() for v in rows]
            return r, rows, np.array(gaps), np.array(scale)
        part = ref.astype(np.int32)
        temp = np.float32(max(temp * np.float32(CFG.anneal),
                              np.float32(CFG.temp_min)))
    return None


@pytest.mark.parametrize("v", [300, 600])
def test_plan_shards_splits_from_the_reference_only_at_a_near_tie(v):
    """At seed 0 the replayed refinement splits from the reference's at
    round 18 on one row whose two best target bins' gains differ by ~1e-7
    (float32 rounding of gains near 3). From there the trajectories are
    different walks: the partitioner's makespans stay within 1.05x, while
    the capacity repair on the two different partitions moves different
    cold rows (its row-count clamp, not the makespan, decides them), so
    the repaired plans' makespans are not banded. Downstream of
    ``partition()`` everything is exact: the port's repair of the
    reference's own partition is the reference's plan."""
    js, want, got = _plan_both(v, seed=0)
    u, vv, w = js.pair_arrays()
    nw = np.maximum(js.counts, max(float(js.counts.max()), 1.0) * 1e-3)
    g = jfrom_edges(v, u, vv, w.astype(np.float32), nw.astype(np.float32))
    jt, tt = _topos(MACHINE)
    split = _first_split(g, jt, seed=0)
    assert split is not None, "trajectories agree: the plans must be equal"
    r, rows, gaps, scale = split
    assert (gaps <= 1e-6 * scale).all(), (
        f"round {r}: rows {rows.tolist()} differ by gains {gaps.tolist()}")
    ref = jpartition(g, jt, JConfig(seed=0))
    res = partition(interop.graph_from_arrays(g), tt, PartitionConfig(seed=0),
                    device="cpu", draws=JaxDraws(0))
    assert res.makespan <= 1.05 * ref.makespan
    repaired = tst._repair_capacity(np.asarray(ref.part, np.int64), js.counts,
                                    tt, 0.2)
    np.testing.assert_array_equal(repaired, want.row_to_device)


def _table_and_plan(v=300, e=32, seed=0):
    js, want, got = _plan_both(v, seed)
    table = np.random.default_rng(1).normal(0, 1, (v, e)).astype(np.float32)
    return want, got, table


def test_sharded_table_matches_reference():
    jplan, tplan, table = _table_and_plan()
    jt = jst.ShardedEmbeddingTable(jnp.asarray(table), jplan)
    tt = tst.ShardedEmbeddingTable(torch.from_numpy(table),
                                   interop.shard_plan_from(jplan))
    np.testing.assert_array_equal(tt.data.numpy(), np.asarray(jt.data))
    np.testing.assert_array_equal(tt.replicated().numpy(), table)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 300, 50)
    np.testing.assert_array_equal(tt.lookup(torch.from_numpy(ids)).numpy(),
                                  table[ids])
    bags = rng.integers(-1, 300, (8, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        tt.translate(torch.from_numpy(bags)).numpy(),
        np.asarray(jt.translate(jnp.asarray(bags))))
    np.testing.assert_array_equal(tt.device_of(ids), jt.device_of(ids))
    valid = bags >= 0
    w = (valid / np.maximum(valid.sum(-1, keepdims=True), 1)).astype(
        np.float32)
    # fused lookup vs the reference's kernel in interpret mode
    got = tt.lookup_bags(torch.from_numpy(bags), torch.from_numpy(w)).numpy()
    want = np.asarray(jt.lookup_bags(jnp.asarray(bags), jnp.asarray(w),
                                     interpret=True))
    rows = torch.from_numpy(table[np.maximum(bags, 0)])
    bound = bag_combine.order_tolerance(rows, torch.from_numpy(w)).numpy()
    assert (np.abs(got - want) <= 1e-6 * np.abs(want) + bound).all()
    # bitwise the plain embedding bag over the original table
    assert np.array_equal(got, ops.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(np.maximum(bags, 0)),
        torch.from_numpy(w)).numpy())


def test_sharded_table_updates_rows_in_place():
    jplan, _, table = _table_and_plan()
    plan = interop.shard_plan_from(jplan)
    tt = tst.ShardedEmbeddingTable(torch.from_numpy(table.copy()), plan)
    jt = jst.ShardedEmbeddingTable(jnp.asarray(table), jplan)
    ids = np.array([3, 0, 299, 17])
    vals = np.random.default_rng(3).normal(0, 1, (4, 32)).astype(np.float32)
    tt.update_rows(torch.from_numpy(ids), torch.from_numpy(vals))
    jt.update_rows(jnp.asarray(ids), jnp.asarray(vals))
    np.testing.assert_array_equal(tt.data.numpy(), np.asarray(jt.data))
    np.testing.assert_array_equal(tt.replicated().numpy()[ids], vals)
    with pytest.raises(ValueError, match="rows"):
        tst.ShardedEmbeddingTable(torch.zeros(5, 2), plan)


def test_gather_combine_reference_padding_row():
    """Padding slots point at row 0 with weight 0, as in the reference."""
    table = torch.arange(12, dtype=torch.float32).view(4, 3)
    idx = torch.tensor([[2, 0, 0]], dtype=torch.int32)
    w = torch.tensor([[0.5, 0.0, 0.0]])
    np.testing.assert_array_equal(ops.gather_combine(table, idx, w).numpy(),
                                  np.asarray(jops.gather_combine(
                                      jnp.asarray(table.numpy()),
                                      jnp.asarray(idx.numpy()),
                                      jnp.asarray(w.numpy()),
                                      interpret=True)))
