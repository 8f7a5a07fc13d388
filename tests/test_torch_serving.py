"""Port parity for the serving stack: the page allocator, page tables,
placement relabelling and scheduler bookkeeping pinned exactly against
``repro.serving`` under the same operation streams; ``lint_traffic``'s
findings; ``map_pages`` (its degenerate branch exactly, its partition
branch within the 1.05x makespan band); ``paged_decode_step`` against the
reference's and paged == dense decode within the port; and the engine's
tokens against the reference engine's (greedy, and at temperature 0.8 with
the reference's Gumbel noise injected). Smoke width, float32, the
reference's weights carried across by ``interop.transformer_params_from``.
"""
import dataclasses
import functools
import io
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.analysis import shard_lint as jlint
from repro.core import baselines as jbaselines
from repro.core.topology import guess_tree as jguess_tree
from repro.dist.sharding import lm_rules
from repro.graph.graph import from_edges as jfrom_edges
from repro.launch.placement import PlacementSession as JSession
from repro.models import transformer as jtr
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JEngine
from repro.serving import kv_cache as jkv
from repro.serving import scheduler as jsched
from repro.serving.paged_decode import paged_decode_step as jpaged
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.analysis import shard_lint as tlint
from repro_torch.launch import serve as tserve
from repro_torch.launch.placement import PlacementSession as TSession
from repro_torch.models import transformer as ttr
from repro_torch.serving import EngineConfig, PagedKVCache, ServingEngine
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving import scheduler as tsched
from repro_torch.serving.paged_decode import paged_decode_step

torch.set_num_threads(1)
RULES = lm_rules(())
NAMES = ["qwen2-1.5b", "chatglm3-6b"]
# paged against dense decode: the reference's own band
# (tests/test_serving.py:137-138)
PAGED_TOL = dict(rtol=1e-5, atol=1e-5)
# port against reference logits: float32 sums in other orders over 2
# layers (measured ~5e-7 of the largest logit in tests/test_torch_lm.py)
LOGIT_RTOL = 2e-5
# map_pages' partition branch: the device-vs-host quality band the
# reference pins (tests/test_device_vcycle.py)
BAND = 1.05


def _assert_logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    err = np.abs(got - want)
    assert np.all(err <= LOGIT_RTOL * (scale + np.abs(want))), \
        (float(err.max()), scale)


@functools.lru_cache(maxsize=None)
def _reference(name):
    cfg = jconfigs.get(name).smoke_config()
    params, _ = jtr.init(jax.random.PRNGKey(0), cfg, RULES)
    paged = jax.jit(lambda p, k, v, t2, ln, t: jpaged(p, k, v, t2, ln, t,
                                                      cfg, RULES))
    return cfg, params, paged


@functools.lru_cache(maxsize=None)
def _port(name):
    _, params, _ = _reference(name)
    return (tconfigs.get(name).smoke_config(),
            interop.transformer_params_from(jax.tree.map(np.asarray,
                                                         params)))


def _pools(cfg, n_pages, page_size):
    shape = (cfg.n_layers, n_pages + 1, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    return torch.zeros(shape), torch.zeros(shape)


# ---------------------------------------------------------------------------
# host bookkeeping, pinned exactly
# ---------------------------------------------------------------------------

def _cache_state(cache):
    al = cache.allocator
    return dict(free=list(al._free), owned=al._owned.tolist(),
                dead=al._dead.tolist(), table=cache.page_table.tolist(),
                slots={s: list(p) for s, p in cache.slot_pages.items()},
                access=cache.access_count.tolist(),
                traffic=cache.traffic.tolist())


def _sched_state(s):
    def req(r):
        return (r.rid, r.pos, list(r.generated), r.slot, r.admit_step,
                r.first_token_step, r.done_step, r.retries, r.replay_gen,
                r.not_before, r.failed, r.fail_reason, r.fail_step)
    return dict(cache=_cache_state(s.cache),
                queue=[req(r) for r in s.queue],
                active={k: req(r) for k, r in s.active.items()},
                completed=[req(r) for r in s.completed],
                failed=[req(r) for r in s.failed],
                free_slots=list(s._free_slots))


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_and_cache_bookkeeping_match_reference(seed):
    """One random stream of submits, steps (sampled tokens from the same
    rng), access records, placements and leaf deaths, driven through both
    packages' ``Scheduler`` on a bookkeeping-only ``PagedKVCache``: every
    table, list and count equal after every operation."""
    rng = np.random.default_rng(seed)
    n_pages, page, slots, max_pages = 24, 4, 3, 6
    caches = [m.PagedKVCache(n_pages, page, slots, max_pages)
              for m in (jkv, tkv)]
    scheds = [m.Scheduler(c) for m, c in zip((jsched, tsched), caches)]
    rid = 0
    for step in range(60):
        op = rng.random()
        if op < 0.3:
            prompt = rng.integers(0, 50, int(rng.integers(1, 8)))
            gen = int(rng.integers(1, 8))
            for m, s in zip((jsched, tsched), scheds):
                s.submit(m.Request(rid=rid, prompt=prompt.astype(np.int32),
                                   max_new_tokens=gen), step=step)
            rid += 1
        elif op < 0.85:
            outs = []
            for s in scheds:
                s.admit(step)
                ins = s.step_inputs()
                outs.append(ins)
            assert [dataclasses.astuple(i) for i in outs[0]] == \
                [dataclasses.astuple(i) for i in outs[1]]
            toks = {i.slot: int(rng.integers(0, 50)) for i in outs[0]}
            for s, ins in zip(scheds, outs):
                s.cache.record_access({i.slot: i.pos + 1 for i in ins})
                for i in ins:
                    s.advance(i.slot, step,
                              toks[i.slot] if i.needs_sample else None)
        elif op < 0.93:
            asg = rng.integers(0, 3, n_pages)
            perms = [c.apply_placement(asg) for c in caches]
            np.testing.assert_array_equal(perms[0], perms[1])
        else:
            live = [p for p in range(n_pages)
                    if not caches[0].allocator._dead[p]]
            dead = sorted(rng.choice(live, min(2, len(live)),
                                     replace=False).tolist())
            res = [s.handle_leaf_death(dead, step, max_retries=1)
                   for s in scheds]
            assert [[r.rid for r in res[i]["requeued"]] for i in (0, 1)] \
                == [[r.rid for r in res[0]["requeued"]]] * 2
            assert [r.rid for r in res[0]["failed"]] == \
                [r.rid for r in res[1]["failed"]]
        assert _sched_state(scheds[0]) == _sched_state(scheds[1])
        for s in scheds:
            s.check_invariants()


def test_allocator_and_page_table_match_reference():
    """tests/test_serving.py's allocator and page-table round trips, on
    both packages, with the same results and the same errors."""
    allocs = []
    for m in (jkv, tkv):
        al = m.PageAllocator(8)
        a, b = al.alloc(3), al.alloc(2)
        al.free(a)
        c = al.alloc(3)
        assert set(c) == set(a)                       # LIFO reuse
        allocs.append((a, b, c, list(al._free)))
        al.free(b)
        with pytest.raises(ValueError, match="double free"):
            al.free(b)
        before = al.n_free
        with pytest.raises(m.PagePoolExhausted):
            al.alloc(before + 1)
        assert al.n_free == before
    assert allocs[0] == allocs[1]
    states = []
    for m in (jkv, tkv):
        cache = m.PagedKVCache(n_pages=12, page_size=4, n_slots=3,
                               max_pages_per_req=4)
        cache.assign_slot(0, 10)
        with pytest.raises(ValueError, match="already holds"):
            cache.assign_slot(0, 4)
        cache.assign_slot(1, 16)
        cache.release_slot(0)
        cache.assign_slot(2, 10)
        with pytest.raises(KeyError):
            cache.release_slot(0)
        with pytest.raises(ValueError, match="max_pages_per_req"):
            cache.assign_slot(0, 100)
        cache.record_access({1: 16, 2: 7})
        cache.fail_pages(sorted(cache.allocator._free)[:2])
        states.append(_cache_state(cache))
    assert states[0] == states[1]


def test_apply_placement_and_fail_pages_move_the_pools():
    """The port's pools follow the relabelling (``index_select``) and
    dead pages' rows are zeroed; the sentinel row stays put."""
    cfg = tconfigs.get("qwen2-1.5b").smoke_config()
    cache = PagedKVCache(6, 2, 2, 3, cfg=cfg, device="cpu")
    cache.k_pool.copy_(torch.arange(cache.k_pool.numel(),
                                    dtype=torch.float32).view_as(
                                        cache.k_pool))
    before = cache.k_pool.clone()
    perm = cache.apply_placement(np.array([2, 0, 1, 0, 2, 1]))
    for old, new in enumerate(perm):
        assert torch.equal(cache.k_pool[:, new], before[:, old])
    assert torch.equal(cache.k_pool[:, 6], before[:, 6])
    cache.fail_pages([1, 4])
    assert not cache.k_pool[:, [1, 4]].any()
    assert torch.equal(cache.k_pool[:, 6], before[:, 6])


# ---------------------------------------------------------------------------
# lint_traffic and map_pages
# ---------------------------------------------------------------------------

def _matrices():
    rng = np.random.default_rng(0)
    sym = rng.random((5, 5))
    sym = sym + sym.T
    np.fill_diagonal(sym, 0)
    asym = sym.copy()
    asym[0, 1] += 1
    diag = sym.copy()
    diag[2, 2] = 3
    neg = sym.copy()
    neg[1, 3] = neg[3, 1] = -2
    nan = sym.copy()
    nan[0, 4] = np.nan
    return {"clean": sym, "asymmetric": asym, "diagonal": diag,
            "negative": neg, "nan": nan, "shape": np.zeros((3, 4)),
            "missing": None, "zeros": np.zeros((4, 4))}


@pytest.mark.parametrize("key", list(_matrices()))
def test_lint_traffic_findings_match_reference(key):
    m = _matrices()[key]
    want = jlint.lint_traffic(m, subject="page-traffic")
    got = tlint.lint_traffic(m, subject="page-traffic")
    assert [(f.check, f.severity, f.subject, f.message, f.detail)
            for f in got] == [(f.check, f.severity, f.subject, f.message,
                               f.detail) for f in want]


def _cliques(n=16, size=8):
    traffic = np.zeros((n, n))
    for lo in range(0, n, size):
        idx = np.arange(lo, lo + size)
        traffic[np.ix_(idx, idx)] = 10.0
    np.fill_diagonal(traffic, 0.0)
    return traffic


@pytest.mark.parametrize("case", ["empty", "fewer_pages_than_bins",
                                  "empty_with_current"])
def test_map_pages_degenerate_branch_matches_reference(case):
    traffic, kw = np.zeros((8, 8)), {}
    if case == "fewer_pages_than_bins":
        traffic = _cliques(3, 3)
    if case == "empty_with_current":
        kw = dict(current=np.arange(8) % 4)
    want = JSession(cache_dir="").map_pages(traffic, n_devices=4, **kw)
    got = TSession(device="cpu").map_pages(traffic, n_devices=4, **kw)
    np.testing.assert_array_equal(got.page_to_device, want.page_to_device)
    assert (got.n_devices, got.drift_ratio, got.replaced) == \
        (want.n_devices, want.drift_ratio, want.replaced)
    assert got.makespan == pytest.approx(want.makespan, rel=1e-6)


def _engine_traffic():
    """Page co-access measured by the port's engine on the smoke model."""
    cfg, params = _port("qwen2-1.5b")
    eng = ServingEngine(params, cfg, EngineConfig(
        n_slots=4, page_size=2, n_pages=48, max_pages_per_req=8,
        temperature=0.0), device="cpu")
    for prompt, gen in _workload(cfg, n=10, seed=5):
        eng.submit(prompt, gen)
    for _ in range(12):
        eng.step()
    return eng.cache.page_traffic(), eng.cache.page_weight()


@pytest.mark.parametrize("case", ["cliques", "engine_epoch"])
def test_map_pages_partition_within_band_of_reference(case):
    """Both placements scored by the reference's ``score_all`` on the
    reference's machine tree: the port's makespan within 1.05x."""
    if case == "cliques":
        traffic, weight = _cliques(), None
    else:
        traffic, weight = _engine_traffic()
    want = JSession(cache_dir="").map_pages(traffic, node_weight=weight,
                                            n_devices=4)
    got = TSession(device="cpu").map_pages(traffic, node_weight=weight,
                                           n_devices=4)
    n = traffic.shape[0]
    assert got.page_to_device.shape == (n,) and got.n_devices == 4
    nw = np.asarray(weight if weight is not None else traffic.sum(1))
    nw = np.maximum(nw, max(float(nw.max()), 1.0) * 1e-3)
    iu = np.triu_indices(n, 1)
    nz = traffic[iu] > 0
    g = jfrom_edges(n, iu[0][nz], iu[1][nz],
                    traffic[iu][nz].astype(np.float32),
                    nw.astype(np.float32))
    topo = jguess_tree(4)
    ours = jbaselines.score_all(g, topo, got.page_to_device)["makespan"]
    theirs = jbaselines.score_all(g, topo, want.page_to_device)["makespan"]
    assert ours <= BAND * theirs
    assert got.makespan == pytest.approx(ours, rel=1e-5)
    scatter = np.arange(n) % 4
    again = TSession(device="cpu").map_pages(traffic, node_weight=weight,
                                             n_devices=4, current=scatter)
    assert again.drift_ratio >= 1.0


@pytest.mark.parametrize("seeds", [1, 2, 3])
def test_map_pages_passes_seeds_to_partition(monkeypatch, seeds):
    """``seeds=`` reaches the partitioner's config beside the session's
    seed, as in the reference's ``map_pages``."""
    from repro_torch.core import partitioner
    seen = []
    real = partitioner.partition

    def spy(g, topo, cfg=None, **kw):
        seen.append(cfg)
        return real(g, topo, cfg, **kw)
    monkeypatch.setattr(partitioner, "partition", spy)
    got = TSession(seed=7, device="cpu").map_pages(_cliques(), n_devices=4,
                                                    seeds=seeds)
    assert [(c.seed, c.seeds) for c in seen] == [(7, seeds)]
    assert got.page_to_device.shape == (16,)


@pytest.mark.parametrize("case", ["cliques", "engine_epoch"])
def test_map_pages_seeds_2_no_worse_and_within_band_of_reference(case):
    """Best of two starts: the port's makespan at or below its own
    ``seeds=1`` placement's on the same traffic, and within 1.05x of the
    reference's ``map_pages(..., seeds=2)``, both scored by the
    reference's ``score_all``."""
    if case == "cliques":
        traffic, weight = _cliques(), None
    else:
        traffic, weight = _engine_traffic()
    one = TSession(device="cpu").map_pages(traffic, node_weight=weight,
                                           n_devices=4)
    two = TSession(device="cpu").map_pages(traffic, node_weight=weight,
                                           n_devices=4, seeds=2)
    want = JSession(cache_dir="").map_pages(traffic, node_weight=weight,
                                            n_devices=4, seeds=2)
    assert two.makespan <= one.makespan
    n = traffic.shape[0]
    nw = np.asarray(weight if weight is not None else traffic.sum(1))
    nw = np.maximum(nw, max(float(nw.max()), 1.0) * 1e-3)
    iu = np.triu_indices(n, 1)
    nz = traffic[iu] > 0
    g = jfrom_edges(n, iu[0][nz], iu[1][nz],
                    traffic[iu][nz].astype(np.float32),
                    nw.astype(np.float32))
    topo = jguess_tree(4)
    ours = jbaselines.score_all(g, topo, two.page_to_device)["makespan"]
    theirs = jbaselines.score_all(g, topo, want.page_to_device)["makespan"]
    assert ours <= BAND * theirs
    assert two.makespan == pytest.approx(ours, rel=1e-5)


def test_map_pages_refuses_malformed_traffic():
    bad = np.zeros((4, 4))
    bad[0, 1] = 1.0
    with pytest.raises(ValueError, match="page-traffic"):
        TSession(device="cpu").map_pages(bad, n_devices=2)
    with pytest.raises(ValueError, match="machine or n_devices"):
        TSession(device="cpu").map_pages(np.zeros((4, 4)))


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_paged_decode_step_matches_reference(name):
    """Same pools, fragmented page tables, mixed lengths and tokens through
    both packages' paged step: logits and pools agree."""
    jcfg, jparams, jstep = _reference(name)
    cfg, params = _port(name)
    b, page, n_pages, t = 3, 4, 16, 9
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    pt = np.full((b, 3), n_pages, np.int32)
    pt[0], pt[1], pt[2, :2] = [7, 2, 11], [0, 9, 3], [5, 14]
    starts = np.array([0, 2, 4])
    kp, vp = _pools(cfg, n_pages, page)
    jk, jv = jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy())
    for step in range(t):
        lengths = np.clip(step - starts, 0, None).astype(np.int32)
        tok = toks[np.arange(b), lengths][:, None]
        want, jk, jv = jstep(jparams, jk, jv, jnp.asarray(pt),
                             jnp.asarray(lengths), jnp.asarray(tok))
        got = paged_decode_step(params, kp, vp, torch.from_numpy(pt),
                                torch.from_numpy(lengths),
                                torch.from_numpy(tok), cfg)
        _assert_logits_close(got, want)
    np.testing.assert_allclose(kp.numpy(), np.asarray(jk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(vp.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_paged_equals_dense_decode(name):
    """tests/test_serving.py's load-bearing test within the port: the
    same tokens through fragmented physical pages and through the dense
    ``decode_step``."""
    cfg, params = _port(name)
    b, t, page, n_pages = 2, 10, 4, 16
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, t)))
    cache = ttr.init_cache(cfg, b, t, device="cpu")
    kp, vp = _pools(cfg, n_pages, page)
    pt = torch.tensor([[7, 2, 11], [0, 9, 3]])
    for pos in range(t - 1):
        lg_d, cache = ttr.decode_step(params, cache, toks[:, pos:pos + 1],
                                      pos, cfg)
        lg_p = paged_decode_step(params, kp, vp, pt,
                                 torch.full((b,), pos), toks[:, pos:pos + 1],
                                 cfg)
        np.testing.assert_allclose(lg_p.numpy(), lg_d.numpy(), **PAGED_TOL)


# the reference's MoE paged-decode config (tests/test_serving.py,
# test_moe_config_paged_decode): qwen2's smoke widths with MoE layers after
# the first, at a capacity that never drops, and its band
MOE_PAGED = dict(moe=True, n_experts=4, n_shared=1, top_k=2, d_ff_expert=32,
                 n_dense_layers=1, capacity_factor=64.0)
MOE_PAGED_TOL = dict(rtol=2e-4, atol=2e-4)


@functools.lru_cache(maxsize=None)
def _moe_model():
    jcfg = dataclasses.replace(jconfigs.get("qwen2-1.5b").smoke_config(),
                               **MOE_PAGED)
    params, _ = jtr.init(jax.random.PRNGKey(0), jcfg, RULES)
    cfg = dataclasses.replace(tconfigs.get("qwen2-1.5b").smoke_config(),
                              **MOE_PAGED)
    return jcfg, params, cfg, interop.transformer_params_from(
        jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("against", ["dense", "reference"])
def test_moe_config_paged_decode(against):
    """MoE layers (no MLA) go through the paged path: paged equals the
    port's dense ``decode_step`` within the reference's 2e-4, and the
    reference's paged step within the parity band."""
    jcfg, jparams, cfg, params = _moe_model()
    assert [cfg.moe_layer(li) for li in range(cfg.n_layers)] == [False,
                                                                 True]
    b, t, page = 2, 6, 2
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (b, t)))
    cache = ttr.init_cache(cfg, b, t, device="cpu")
    kp, vp = _pools(cfg, 8, page)
    jk, jv = jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy())
    pt = torch.tensor([[0, 1, 2], [5, 4, 3]])
    jstep = jax.jit(lambda p, k, v, t2, ln, tk: jpaged(p, k, v, t2, ln, tk,
                                                       jcfg, RULES))
    for pos in range(t - 1):
        tok = toks[:, pos:pos + 1]
        lg_p = paged_decode_step(params, kp, vp, pt, torch.full((b,), pos),
                                 tok, cfg)
        if against == "dense":
            lg_d, cache = ttr.decode_step(params, cache, tok, pos, cfg)
            np.testing.assert_allclose(lg_p.numpy(), lg_d.numpy(),
                                       **MOE_PAGED_TOL)
        else:
            want, jk, jv = jstep(jparams, jk, jv, jnp.asarray(pt.numpy()),
                                 jnp.full((b,), pos, jnp.int32),
                                 jnp.asarray(tok.numpy()))
            _assert_logits_close(lg_p, want)


def test_placement_permutation_preserves_logits():
    cfg, params = _port("qwen2-1.5b")
    b, t, page, n_pages = 2, 8, 2, 12
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (b, t)))

    def run(with_placement):
        cache = PagedKVCache(n_pages, page, b, t // page, cfg=cfg,
                             device="cpu")
        cache.assign_slot(0, t)
        cache.assign_slot(1, t)
        out = []
        for pos in range(t - 1):
            out.append(paged_decode_step(
                params, cache.k_pool, cache.v_pool,
                torch.from_numpy(cache.page_table), torch.full((b,), pos),
                toks[:, pos:pos + 1], cfg))
            if with_placement and pos == 3:
                cache.apply_placement(
                    np.random.default_rng(7).integers(0, 4, n_pages))
                cache.check_invariants()
        return out

    for a, c in zip(run(False), run(True)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), **PAGED_TOL)


def test_mla_cache_not_paged_yet():
    cfg = dataclasses.replace(tconfigs.get("qwen2-1.5b").smoke_config(),
                              mla=True)
    with pytest.raises(NotImplementedError, match="MLA"):
        PagedKVCache(8, 4, 2, 4, cfg=cfg, device="cpu")


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _workload(cfg, n=6, seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab, int(rng.integers(2, 7)),
                          dtype=np.int64).astype(np.int32),
             int(rng.integers(1, 5))) for _ in range(n)]


ENGINE_DEFAULTS = dict(n_slots=2, page_size=4, n_pages=16,
                       max_pages_per_req=4, temperature=0.8, seed=0,
                       replace_every=0)


def _run_port(name, work, noise=None, **kw):
    cfg, params = _port(name)
    eng = ServingEngine(params, cfg, EngineConfig(**{**ENGINE_DEFAULTS,
                                                     **kw}),
                        device="cpu", noise=noise)
    for prompt, gen in work:
        eng.submit(prompt, gen)
    return eng.run()


def _run_reference(name, work, **kw):
    cfg, params, _ = _reference(name)
    eng = JEngine(params, cfg, RULES, JEngineConfig(**{**ENGINE_DEFAULTS,
                                                       **kw}))
    for prompt, gen in work:
        eng.submit(prompt, gen)
    return eng.run()


def _tokens(report):
    return {r["rid"]: r["generated"] for r in report.requests}


class JaxGumbel:
    """The reference engine's sampling noise, key by key:
    ``gumbel(fold_in(fold_in(PRNGKey(seed), rid), pos), (V,))``."""

    def __init__(self, seed):
        self.base = jax.random.PRNGKey(seed)

    def gumbel(self, rid, pos, n):
        key = jax.random.fold_in(jax.random.fold_in(self.base, rid), pos)
        return torch.from_numpy(np.array(jax.random.gumbel(
            key, (n,), jnp.float32)))


@pytest.mark.parametrize("name", NAMES)
def test_engine_greedy_tokens_equal_reference(name):
    cfg, _ = _port(name)
    work = _workload(cfg, n=6, seed=11)
    want = _run_reference(name, work, temperature=0.0)
    got = _run_port(name, work, temperature=0.0)
    assert _tokens(got) == _tokens(want)
    for field in ("n_requests", "steps", "tokens_out", "latency_steps_p50",
                  "latency_steps_p99", "ttft_steps_p50", "ttft_steps_p99",
                  "mean_batch_occupancy"):
        assert getattr(got, field) == getattr(want, field), field


def test_categorical_is_gumbel_argmax_in_the_installed_jax():
    """The sampler's premise: ``jax.random.categorical(key, x)`` equals
    ``argmax(x + gumbel(key, x.shape))``."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((16, 40)),
                    jnp.float32)
    for i in range(16):
        key = jax.random.fold_in(jax.random.PRNGKey(3), i)
        assert int(jax.random.categorical(key, x[i])) == int(jnp.argmax(
            x[i] + jax.random.gumbel(key, (40,), jnp.float32)))


@pytest.mark.parametrize("name", NAMES)
def test_engine_sampled_tokens_equal_reference_with_its_noise(name):
    cfg, _ = _port(name)
    work = _workload(cfg, n=6, seed=12)
    want = _run_reference(name, work, temperature=0.8)
    got = _run_port(name, work, noise=JaxGumbel(0), temperature=0.8)
    assert _tokens(got) == _tokens(want)


def test_engine_tokens_identical_across_slot_counts():
    """Sampling keyed by (rid, pos) only: the same tokens at 2 and 4 slots
    (tests/test_serving.py:294-305), with the port's own noise."""
    cfg, _ = _port("qwen2-1.5b")
    work = _workload(cfg)
    r2 = _run_port("qwen2-1.5b", work, n_slots=2)
    r4 = _run_port("qwen2-1.5b", work, n_slots=4, n_pages=32)
    assert _tokens(r2) == _tokens(r4)
    assert r4.steps <= r2.steps


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_placement_does_not_change_an_answer(temperature):
    cfg, _ = _port("qwen2-1.5b")
    work = _workload(cfg, n=8, seed=4)
    on = _run_port("qwen2-1.5b", work, temperature=temperature,
                   replace_every=3, place_devices=4, n_pages=24)
    off = _run_port("qwen2-1.5b", work, temperature=temperature,
                    n_pages=24)
    assert on.placements and any(p["replaced"] for p in on.placements)
    assert _tokens(on) == _tokens(off)


def test_engine_completes_all_and_reports():
    cfg, _ = _port("qwen2-1.5b")
    work = _workload(cfg, n=5, seed=3)
    rep = _run_port("qwen2-1.5b", work, replace_every=6, place_devices=4)
    assert rep.n_requests == len(work)
    assert rep.tokens_out == sum(g for _, g in work)
    for r in rep.requests:
        assert r["first_token_step"] - r["admit_step"] == (
            r["prompt_len"] - 1)
        assert len(r["generated"]) == r["max_new_tokens"]
    assert rep.placements
    assert rep.latency_steps_p99 >= rep.latency_steps_p50 > 0
    import json
    json.loads(rep.to_json())


def test_engine_static_batching_and_rejections():
    cfg, params = _port("qwen2-1.5b")
    work = _workload(cfg, n=4, seed=9)
    cont = _run_port("qwen2-1.5b", work, temperature=0.0)
    stat = _run_port("qwen2-1.5b", work, temperature=0.0,
                     static_batching=True)
    assert _tokens(cont) == _tokens(stat)
    assert cont.steps <= stat.steps
    eng = ServingEngine(params, cfg, EngineConfig(
        n_slots=1, page_size=2, n_pages=4, max_pages_per_req=4),
        device="cpu")
    with pytest.raises(ValueError, match="max_pages_per_req|never"):
        eng.submit(np.zeros(16, np.int32), 8)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, params = _port("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(params, cfg, EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(8, 4, 2, 4, cfg=cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSession().map_pages(_cliques(), n_devices=4)


def test_serve_cli_streams_on_the_cpu(monkeypatch):
    """``python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke
    --device cpu``: the reference CLI's default stream (16 requests, 4
    slots, placement every 16 steps) runs to its end."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
        "--place-devices", "4"])
    out = io.StringIO()
    with redirect_stdout(out):
        tserve.main()
    text = out.getvalue()
    assert "[SERVE] 16 requests" in text
    assert "placement step=16 devices=4" in text
    assert "--fault-plan" in tserve._parser().format_help()


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "deepseek-v2-236b"])
def test_serve_cli_oneshot_runs_mla_on_the_cpu(name, monkeypatch):
    """``--oneshot`` drives MLA's absorbed decode and the MoE layers
    (``--smoke --device cpu``); the same seed gives the same tokens."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", name, "--smoke", "--device", "cpu", "--oneshot",
        "--batch", "2", "--prompt-len", "5", "--gen-len", "6"])
    out = io.StringIO()
    with redirect_stdout(out):
        tserve.main()
    assert "generated (2, 6) tokens" in out.getvalue()
    cfg = tconfigs.get(name).smoke_config()
    params = ttr.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    runs = [tserve.oneshot(params, cfg, torch.device("cpu"), 2, 5, 6, 0.8,
                           seed=3) for _ in range(2)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert runs[0][0].shape == (2, 6) and runs[0][2] == 10


def test_serve_cli_stream_refuses_mla(monkeypatch):
    """The stream runs the paged GQA cache, which MLA's rank-compressed
    cache has no pages for: it raises the reference's refusal."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "deepseek-v2-lite-16b", "--smoke", "--device",
        "cpu"])
    with pytest.raises(NotImplementedError, match="MLA"):
        tserve.main()
