"""Port parity for two-tower retrieval training: the in-batch softmax loss
and its gradients against ``jax.value_and_grad`` of the reference's
``loss_fn`` (with and without a row permutation), ``bag_combine``'s
autograd and the deterministic row gather, the three rowwise-Adagrad
update paths, the sparse train step over three steps, the hot-row cache's
counters and traffic against the reference cache, the prefetcher, the
loop's embed state, the config, and the train CLI's recsys family on the
CPU. SMOKE widths, float32, the reference's weights carried across by
``interop.recsys_params_from``."""
import functools
import itertools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import embed as jembed
from repro.configs import two_tower_retrieval as jtt
from repro.data import pipeline as jpipeline
from repro.dist.sharding import recsys_rules
from repro.embed import training as jtraining
from repro.models import recsys as jrecsys
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch import embed as tembed
from repro_torch import interop, tree
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import two_tower_retrieval as ttt
from repro_torch.embed import training as ttraining
from repro_torch.kernels import bag_combine, ops
from repro_torch.launch import train as tlaunch
from repro_torch.models import recsys as trecsys
from repro_torch.optim import adamw as tadamw
from repro_torch.train import loop
from repro_torch.train.steps import loss_and_grads

torch.set_num_threads(1)
RULES = recsys_rules(())
# the train phase's float32 bands (kernel path against plain path): float32
# sums in other orders
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
ROW_TOL = 1e-6


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def _models():
    """The reference's SMOKE params and the port's copy of them."""
    jp, _ = jrecsys.init(jax.random.PRNGKey(0), jtt.SMOKE, RULES)
    jp = jax.tree.map(np.asarray, jp)
    model = trecsys.TwoTower(ttt.SMOKE, device="meta")
    model.load_state_dict(interop.recsys_params_from(jp), assign=True)
    return jp, trecsys.params_of(model)


def _batch(b=48, seed=3):
    return next(jpipeline.recsys_batches(ttt.SMOKE.n_items, ttt.SMOKE.n_cats,
                                         b, ttt.SMOKE.hist_len,
                                         ttt.SMOKE.d_dense, seed=seed))


def _tbatch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _perm(n, seed=4):
    return np.random.default_rng(seed).permutation(n)


def _permuted(jp, tp, perm):
    """The item table laid out by ``perm`` (old -> new): both packages'
    params with ``table[perm[i]] = original row i``."""
    order = np.argsort(perm)
    jp = dict(jp, item_table=jp["item_table"][order])
    tp = dict(tp, item_table=tp["item_table"][torch.from_numpy(order)])
    return jp, tp


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("permuted", [False, True])
def test_loss_and_grads_match_the_reference(permuted):
    jp, tp = _models()
    b = _batch()
    perm = None
    if permuted:
        perm = _perm(jp["item_table"].shape[0])
        jp, tp = _permuted(jp, tp, perm)
    jperm = None if perm is None else jnp.asarray(perm)
    (jloss, jaux), jg = jax.value_and_grad(
        lambda p: jrecsys.loss_fn(p, jax.tree.map(jnp.asarray, b),
                                  jtt.SMOKE, RULES, jperm),
        has_aux=True)(jax.tree.map(jnp.asarray, jp))
    tperm = None if perm is None else torch.from_numpy(perm)
    tloss, taux, tg = loss_and_grads(
        lambda p, bt: trecsys.loss_fn(p, bt, ttt.SMOKE, tperm), tp,
        _tbatch(b))
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert float(taux["acc"]) == float(jaux["acc"])
    jl, tl = jax.tree.leaves(jg), tree.leaves(tg)
    assert len(jl) == len(tl) == 10
    for path, (a, w) in zip([p for p, _ in tree.flatten(tg)], zip(tl, jl)):
        assert tuple(a.shape) == w.shape, path
        assert _rel_l2(a.numpy(), w) <= GRAD_REL_L2, path


def test_loss_without_log_q_and_n_params():
    jp, tp = _models()
    b = _batch()
    b.pop("log_q")
    jloss, _ = jrecsys.loss_fn(jax.tree.map(jnp.asarray, jp),
                               jax.tree.map(jnp.asarray, b), jtt.SMOKE, RULES)
    tloss, _ = trecsys.loss_fn(tp, _tbatch(b), ttt.SMOKE)
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    for name in ("SMOKE", "FULL"):
        a, t = getattr(jtt, name), getattr(ttt, name)
        assert t.n_params() == a.n_params() and t.temperature == a.temperature


def test_serving_methods_share_the_functional_code_and_record_nothing():
    jp, tp = _models()
    model = trecsys.TwoTower(ttt.SMOKE, device="meta")
    model.load_state_dict(interop.recsys_params_from(jp), assign=True)
    b = _tbatch(_batch())
    got = model.score(b)
    assert not got.requires_grad
    assert torch.equal(got, trecsys.score(tp, b, ttt.SMOKE))
    g = torch.Generator().manual_seed(0)
    p = trecsys.init(ttt.SMOKE, g, device="cpu")
    m = trecsys.TwoTower(ttt.SMOKE, generator=torch.Generator().manual_seed(
        0), device="cpu")
    for a, c in zip(tree.leaves(p), tree.leaves(m.params())):
        assert torch.equal(a, c) and not a.requires_grad


# ---------------------------------------------------------------------------
# bag_combine's autograd and the row gather
# ---------------------------------------------------------------------------

def test_bag_combine_gradcheck_float64():
    gen = torch.Generator().manual_seed(5)
    g = torch.randn(4, 6, 5, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    w = torch.rand(4, 6, generator=gen, dtype=torch.float64,
                   requires_grad=True)
    assert torch.autograd.gradcheck(bag_combine.bag_combine, (g, w))
    g2 = g.detach().requires_grad_(True)
    assert torch.autograd.gradcheck(bag_combine.bag_combine,
                                     (g2, w.detach()))


def test_embedding_bag_gradcheck_with_duplicate_rows():
    gen = torch.Generator().manual_seed(6)
    table = torch.randn(7, 3, generator=gen, dtype=torch.float64,
                        requires_grad=True)
    idx = torch.tensor([[0, 0, 3], [6, 0, 3]])
    w = torch.rand(2, 3, generator=gen, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda t: ops.embedding_bag(t, idx, w), (table,))


def test_row_gather_backward_is_repeatable_and_the_index_backward():
    gen = torch.Generator().manual_seed(7)
    table = torch.randn(50, 16, generator=gen, requires_grad=True)
    idx = torch.randint(0, 5, (4000,), generator=gen)
    g = torch.randn(4000, 16, generator=gen)
    outs = []
    for _ in range(3):
        (d,) = torch.autograd.grad(ops.take_rows(table, idx), table, g)
        outs.append(d)
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    (want,) = torch.autograd.grad(table[idx], table, g)
    torch.testing.assert_close(outs[0], want, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert not ops.take_rows(table, idx).requires_grad


# ---------------------------------------------------------------------------
# rowwise Adagrad
# ---------------------------------------------------------------------------

def _row_inputs(v=40, e=8, seed=8):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (v, e)).astype(np.float32)
    accum = rng.random(v).astype(np.float32)
    rows = np.sort(rng.choice(v, 13, replace=False))
    g = np.zeros((v, e), np.float32)
    g[rows] = rng.normal(0, 1, (13, e))
    return table, accum, rows, g


def test_row_updates_bitwise_within_torch_and_the_reference():
    table, accum, rows, g = _row_inputs()
    t, a, gt = map(torch.from_numpy, (table, accum, g))
    dense = tembed.dense_row_update(t, a, gt)
    masked = tembed.masked_row_update(t, a, gt)
    sparse = tembed.sparse_row_update(t, a, torch.from_numpy(rows),
                                      gt[torch.from_numpy(rows)])
    for x, y, z in zip(dense, masked, sparse):
        assert torch.equal(x, y) and torch.equal(x, z)
    untouched = np.setdiff1d(np.arange(table.shape[0]), rows)
    assert torch.equal(dense[0][untouched], t[untouched])
    want = jembed.dense_row_update(jnp.asarray(table), jnp.asarray(accum),
                                   jnp.asarray(g))
    for x, w in zip(dense, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=ROW_TOL,
                                   atol=ROW_TOL)
    jsp = jembed.sparse_row_update(jnp.asarray(table), jnp.asarray(accum),
                                   jnp.asarray(rows), jnp.asarray(g[rows]))
    for x, w in zip(sparse, jsp):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=ROW_TOL,
                                   atol=ROW_TOL)


def test_replicated_traffic_requester_and_stats_are_the_reference():
    rng = np.random.default_rng(9)
    for d in (1, 3, 8):
        ids = rng.integers(-1, 50, 300)
        req = rng.integers(0, d, 300)
        np.testing.assert_array_equal(
            tembed.replicated_update_traffic(ids, req, d, 1024.0),
            jembed.replicated_update_traffic(ids, req, d, 1024.0))
        np.testing.assert_array_equal(tembed.requester_of(37, d),
                                      jembed.requester_of(37, d))
    ts, js = tembed.RowAccessStats(80), jembed.RowAccessStats(80)
    for ids in _zipf(80, 6, 5, 4, seed=10):
        ts.record(ids)
        js.record(ids)
    np.testing.assert_array_equal(ts.top_rows(17), js.top_rows(17))
    asg = rng.integers(0, 4, 80)
    np.testing.assert_array_equal(ts.device_traffic(asg, 4, 64.0),
                                  js.device_traffic(asg, 4, 64.0))


# ---------------------------------------------------------------------------
# the sparse train step
# ---------------------------------------------------------------------------

def test_embed_train_step_three_steps_match_the_reference():
    jp, tp = _models()
    ocfg_j = jadamw.AdamWConfig(lr=3e-3, total_steps=3, warmup_steps=0)
    ocfg_t = tadamw.AdamWConfig(lr=3e-3, total_steps=3, warmup_steps=0)
    jecfg, tecfg = jtraining.EmbedConfig(), ttraining.EmbedConfig()
    jstep = jax.jit(jtraining.make_embed_train_step(
        lambda p, b: jrecsys.loss_fn(p, b, jtt.SMOKE, RULES), ocfg_j, jecfg))
    tstep = ttraining.make_embed_train_step(
        lambda p, b: trecsys.loss_fn(p, b, ttt.SMOKE), ocfg_t, tecfg)
    jpp = jax.tree.map(jnp.asarray, jp)
    jo = jtraining.init_dense_opt(jpp, jecfg, ocfg_j)
    je = jtraining.init_embed_state(jpp, jecfg)
    to = ttraining.init_dense_opt(tp, tecfg, ocfg_t)
    te = ttraining.init_embed_state(tp, tecfg)
    assert set(te) == {"item_table", "cat_table"}
    stream = jpipeline.recsys_batches(ttt.SMOKE.n_items, ttt.SMOKE.n_cats,
                                      32, ttt.SMOKE.hist_len,
                                      ttt.SMOKE.d_dense, seed=11)
    for b in itertools.islice(stream, 3):
        jpp, jo, je, jm = jstep(jpp, jo, je, jax.tree.map(jnp.asarray, b))
        tp, to, te, tm = tstep(tp, to, te, _tbatch(b))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            LOSS_RTOL * abs(float(jm["loss"]))
    for a, w in zip(tree.leaves((tp, te)), jax.tree.leaves((jpp, je))):
        assert _rel_l2(a.numpy(), np.asarray(w)) <= GRAD_REL_L2
    for a, w in zip(tree.leaves((to.mu, to.nu)),
                    jax.tree.leaves((jo.mu, jo.nu))):
        assert _rel_l2(a.numpy(), np.asarray(w)) <= 1e-3
    assert int(to.step) == int(jo.step) == 3


def test_embed_step_sparse_equals_dense_bitwise_and_repeats():
    _, tp = _models()
    ocfg = tadamw.AdamWConfig(lr=3e-3, total_steps=3, warmup_steps=0)
    b = _tbatch(_batch(64, seed=12))
    outs = []
    for sparse in (True, False, True):
        ecfg = ttraining.EmbedConfig(sparse=sparse)
        step = ttraining.make_embed_train_step(
            lambda p, bt: trecsys.loss_fn(p, bt, ttt.SMOKE), ocfg, ecfg)
        outs.append(step(tp, ttraining.init_dense_opt(tp, ecfg, ocfg),
                         ttraining.init_embed_state(tp, ecfg), b))
    for other in outs[1:]:
        for a, c in zip(tree.leaves(outs[0][:3]), tree.leaves(other[:3])):
            assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# the hot-row cache against the reference's
# ---------------------------------------------------------------------------

def _zipf(v, batch, hist, n, seed=0, a=1.1):
    rng = np.random.default_rng(seed)
    p = np.arange(1, v + 1, dtype=np.float64) ** (-a)
    p /= p.sum()
    out = []
    for _ in range(n):
        ids = rng.choice(v, size=(batch, hist), p=p)
        out.append(np.where(rng.random(ids.shape) < 0.2, -1,
                            ids).astype(np.int32))
    return out


def _plans(v, d, seed=13):
    """A random row -> device plan in both packages."""
    part = np.random.default_rng(seed).integers(0, d, v)
    order = np.argsort(part, kind="stable")
    perm = np.empty(v, np.int64)
    perm[order] = np.arange(v)
    offsets = np.cumsum(np.concatenate([[0], np.bincount(part,
                                                         minlength=d)]))
    kw = dict(row_to_device=part, n_devices=d, order=order, perm=perm,
              offsets=offsets, makespan=0.0)
    return tembed.ShardPlan(**kw), jembed.ShardPlan(**kw)


@pytest.mark.parametrize("policy,n_cache", [("lru", 0), ("lru", 4),
                                            ("lru", 16), ("static", 16)])
def test_cache_counters_traffic_and_values_match_the_reference(policy,
                                                               n_cache):
    v, e, d = 60, 8, 4
    rng = np.random.default_rng(14)
    table = rng.normal(0, 1, (v, e)).astype(np.float32)
    tplan, jplan = _plans(v, d)
    tc = tembed.HotRowCache(tembed.ShardedEmbeddingTable(
        torch.from_numpy(table), tplan), n_cache, policy)
    jc = jembed.HotRowCache(jembed.ShardedEmbeddingTable(
        jnp.asarray(table), jplan), n_cache, policy)
    stats = tembed.RowAccessStats(v)
    stream = _zipf(v, 6, 5, 5, seed=15)
    for ids in stream[:2]:
        stats.record(ids)
    tc.warm(stats.top_rows(n_cache))
    jc.warm(stats.top_rows(n_cache))
    tacc, jacc = torch.zeros(v), jnp.zeros(v, jnp.float32)
    for ids in stream:
        flat = ids[ids >= 0]
        req = rng.integers(0, d, flat.shape[0])
        np.testing.assert_allclose(tc.lookup(flat, req).numpy(),
                                   np.asarray(jc.lookup(flat, req)),
                                   rtol=ROW_TOL, atol=ROW_TOL)
        rows = np.unique(flat)
        g = rng.normal(0, 1, (rows.shape[0], e)).astype(np.float32)
        tacc = tc.apply_grads(rows, torch.from_numpy(g), tacc)
        jacc = jc.apply_grads(rows, g, jacc)
        tc.check_invariants()
    for f in ("lookups", "hits", "misses", "evictions", "flushes",
              "n_cached", "hit_rate"):
        assert getattr(tc, f) == getattr(jc, f), f
    np.testing.assert_array_equal(tc.traffic, jc.traffic)
    assert tc.pending == jc.pending
    np.testing.assert_allclose(tc.replicated().numpy(),
                               np.asarray(jc.replicated()), rtol=ROW_TOL,
                               atol=ROW_TOL)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), rtol=ROW_TOL)


def test_cache_eviction_never_loses_an_update():
    """A 4-slot LRU under a churning stream: after the flush the table and
    accumulator are bitwise the dense update's."""
    v, e = 60, 8
    rng = np.random.default_rng(16)
    table = torch.from_numpy(rng.normal(0, 1, (v, e)).astype(np.float32))
    tplan, _ = _plans(v, 4)
    cache = tembed.HotRowCache(tembed.ShardedEmbeddingTable(table, tplan),
                               n_cache=4)
    ref_tbl, ref_acc, acc = table.clone(), torch.zeros(v), torch.zeros(v)
    for ids in _zipf(v, 6, 5, 8, seed=17):
        flat = ids[ids >= 0]
        assert torch.equal(cache.lookup(flat), ref_tbl[flat])
        rows = np.unique(flat)
        g = torch.from_numpy(rng.normal(0, 1, (rows.shape[0], e))
                             .astype(np.float32))
        acc = cache.apply_grads(rows, g, acc)
        gd = torch.zeros(v, e)
        gd[rows] = g
        ref_tbl, ref_acc = tembed.dense_row_update(ref_tbl, ref_acc, gd)
        cache.check_invariants()
    assert cache.evictions > 0
    assert torch.equal(cache.replicated(), ref_tbl) and not cache.pending
    assert torch.equal(acc, ref_acc)


def test_sharded_table_sizes():
    tplan, _ = _plans(30, 3)
    st = tembed.ShardedEmbeddingTable(torch.zeros(30, 6), tplan)
    assert st.row_bytes == 24 and st.dim == 6 and st.n_rows == 30
    np.testing.assert_array_equal(st.rows_per_device(), tplan.shard_sizes)


# ---------------------------------------------------------------------------
# the prefetcher
# ---------------------------------------------------------------------------

def test_prefetch_deterministic_and_consumes_on_the_callers_thread():
    def gen():
        rng = np.random.default_rng(17)
        for _ in range(12):
            yield rng.integers(0, 100, 8)
    threads = []

    def consume(x):
        threads.append(threading.get_ident())
        return torch.from_numpy(x)
    pf = tembed.PrefetchIterator(gen(), depth=2, consume=consume)
    got = []
    for x in pf:
        time.sleep(0.01)
        got.append(x)
    assert all(torch.equal(a, torch.from_numpy(b))
               for a, b in zip(got, gen()))
    assert len(got) == 12 and set(threads) == {threading.get_ident()}
    s = pf.stats()
    assert s["max_occupancy"] >= 1 and s["produced"] == s["consumed"] == 12
    pf.close()
    pf.close()


def test_prefetch_passes_the_producers_exception_and_close_stops_it():
    def bad():
        yield 1
        raise RuntimeError("boom")
    pf = tembed.PrefetchIterator(bad(), depth=2)
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="boom"):
        while True:
            next(pf)
    pf.close()
    pf = tembed.PrefetchIterator(itertools.count(), depth=2)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(ValueError, match="depth"):
        tembed.PrefetchIterator(iter(()), depth=0)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def _toy_embed():
    rng = np.random.default_rng(18)
    params = {"item_table": torch.from_numpy(
        rng.normal(0, 0.1, (30, 4)).astype(np.float32)),
        "w": torch.from_numpy(rng.normal(0, 0.1, (4, 2)).astype(np.float32))}

    def loss_fn(p, b):
        err = ops.take_rows(p["item_table"], b["ids"]).mean(1) @ p["w"] \
            - b["y"]
        return torch.mean(err * err), {}

    def batches(start=0):
        r = np.random.default_rng(19)
        for i in itertools.count():
            b = {"ids": torch.from_numpy(r.integers(0, 30, (4, 3))),
                 "y": torch.from_numpy(r.normal(0, 1, (4, 2))
                                       .astype(np.float32))}
            if i >= start:
                yield b
    ocfg = tadamw.AdamWConfig(lr=1e-2, total_steps=8, warmup_steps=0)
    ecfg = ttraining.EmbedConfig(tables=("item_table",))
    step = ttraining.make_embed_train_step(loss_fn, ocfg, ecfg)
    return params, ttraining.init_dense_opt(params, ecfg, ocfg), step, \
        ecfg, batches


def test_loop_threads_embed_state_and_closes_the_prefetcher(tmp_path):
    params, opt, step, ecfg, batches = _toy_embed()
    pf = tembed.PrefetchIterator(batches(), depth=2)
    _, _, straight = loop.run(step, params, opt, pf, loop.LoopConfig(
        total_steps=8, embed_sparse=ecfg))
    assert not pf._thread.is_alive()
    lcfg = loop.LoopConfig(total_steps=8, ckpt_every=4,
                           ckpt_dir=str(tmp_path), embed_sparse=ecfg)
    pf = tembed.PrefetchIterator(batches(), depth=2)
    with pytest.raises(loop.InjectedFailure):
        loop.run(step, params, opt, pf, loop.LoopConfig(
            **{**lcfg.__dict__, "fail_at_step": 6}))
    assert not pf._thread.is_alive()
    like = (params, opt, ttraining.init_embed_state(params, ecfg))
    saved, _ = ckpt.restore(str(tmp_path), like, 4)
    assert float(saved[2]["item_table"].sum()) > 0   # the accumulator
    p2, _, resumed = loop.run(step, params, opt, batches(4), lcfg)
    assert resumed.resumed_from == 4 and resumed.steps_run == 4
    assert resumed.losses == straight.losses[4:]     # bitwise


def test_loop_rejects_grad_compress_with_embed_sparse():
    lcfg = loop.LoopConfig(grad_compress=True,
                           embed_sparse=ttraining.EmbedConfig())
    with pytest.raises(ValueError, match="mutually exclusive"):
        loop.run(lambda *a: a, {}, {}, iter(()), lcfg)


# ---------------------------------------------------------------------------
# the config and the CLI
# ---------------------------------------------------------------------------

def test_config_registered_and_flops_are_the_reference():
    arch = tconfigs.get("two-tower-retrieval")
    assert arch.family == "recsys" and arch.make_config("train") is ttt.FULL
    assert arch.smoke_config() is ttt.SMOKE
    for shape in arch.shapes:
        assert arch.model_flops(shape) == jtt.model_flops(shape), shape
    for k, v in arch.smoke_batch().items():
        np.testing.assert_array_equal(v, jtt.smoke_batch()[k])


def test_train_cli_recsys_on_the_cpu(capsys):
    tlaunch.main(["--arch", "two-tower-retrieval", "--smoke", "--device",
                  "cpu", "--steps", "4", "--batch", "64", "--embed-shard",
                  "--embed-machine", "tpu-mixed-32", "--embed-cache-rows",
                  "32", "--embed-probe-batches", "2", "--prefetch", "2"])
    out = capsys.readouterr().out
    assert "arch=two-tower-retrieval" in out
    assert "leaves of tpu-mixed-32" in out and "embed traffic:" in out
    assert "steps=4 resumed_from=None loss " in out
    assert "prefetch: depth=2 produced=" in out
    rep, cached = out.split("replicated ")[1].split(" B -> ")
    assert float(cached.split(") ")[1].split(" B")[0]) < float(rep)


def test_train_cli_recsys_dense_and_refusals():
    tlaunch.main(["--arch", "two-tower-retrieval", "--smoke", "--device",
                  "cpu", "--steps", "2", "--batch", "16"])
    with pytest.raises(SystemExit, match="recsys"):
        tlaunch.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                      "--embed-shard"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        tlaunch.main(["--arch", "two-tower-retrieval", "--smoke", "--device",
                      "cpu", "--embed-shard", "--grad-compress"])
