"""Port parity for fault recovery: the fault-plan DSL, its JSON form and
``FaultPlan.random`` exactly the reference's; the injector's
exactly-once delivery; the chaos harness's ``ChaosResult`` field for field
against the reference harness (seeded sweep and a hypothesis property);
the serving engine's leaf-death recovery on the qwen2 SMOKE config against
the clean run and against the reference engine (its Gumbel noise
injected); the train loop's injector and ``run_supervised``; both CLIs'
``--fault-plan`` on the CPU."""
import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as jconfigs
from repro import resilience as jres
from repro.dist.sharding import lm_rules
from repro.models import transformer as jtr
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JEngine
from repro_torch import interop
from repro_torch import resilience as tres
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import qwen2_1_5b as tqwen
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.train import loop

torch.set_num_threads(1)
RULES = lm_rules(())
PLANS = ["6:leaf_death:1", "4:link_degrade:dcn:0.5,9:straggler:2:0.5",
         "2:straggler:0,2:leaf_death:3,7:link_degrade:ici",
         " 5:leaf_death:0 , 1:straggler:1:0.25 "]


# ---------------------------------------------------------------------------
# plans and the injector
# ---------------------------------------------------------------------------

def _events(plan):
    return [e.to_dict() for e in plan.events]


@pytest.mark.parametrize("spec", PLANS)
def test_dsl_and_to_json_are_the_reference(spec):
    got, want = tres.parse_fault_plan(spec), jres.parse_fault_plan(spec)
    assert _events(got) == _events(want)
    assert got.to_json() == want.to_json()
    assert got.deaths() == want.deaths() and len(got) == len(want)
    for step in range(10):
        assert [e.to_dict() for e in got.at(step)] == \
            [e.to_dict() for e in want.at(step)]


@pytest.mark.parametrize("spec", PLANS)
def test_json_file_round_trip_is_the_reference(spec, tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(jres.parse_fault_plan(spec).to_json())
    got, want = (tres.parse_fault_plan(str(path)),
                 jres.parse_fault_plan(str(path)))
    assert got.to_json() == want.to_json()
    assert tres.faults.plan_from(got) is got
    assert tres.faults.plan_from(None).events == ()
    assert _events(tres.faults.plan_from(list(got.events))) == _events(got)


@pytest.mark.parametrize("seed", range(10))
def test_random_plans_are_the_references(seed):
    kw = dict(n_deaths=1 + seed % 3, n_link=seed % 2, n_straggler=seed % 3,
              levels=("ici", "dcn"))
    got = tres.FaultPlan.random(seed, 30, 4, **kw)
    want = jres.FaultPlan.random(seed, 30, 4, **kw)
    assert _events(got) == _events(want)
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("bad", [
    dict(step=0, kind="meteor", target=0), dict(step=0, kind="straggler",
                                                target=0, factor=1.5),
    dict(step=0, kind="link_degrade", target=3),
    dict(step=-1, kind="leaf_death", target=0)])
def test_event_validation_matches_the_reference(bad):
    with pytest.raises(ValueError) as want:
        jres.FaultEvent(**bad)
    with pytest.raises(ValueError) as got:
        tres.FaultEvent(**bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="kill"):
        tres.FaultPlan.random(0, 50, 4, n_deaths=4)


def test_injector_fires_each_event_exactly_once_across_step_jumps():
    plan = tres.parse_fault_plan("2:leaf_death:0,5:straggler:1,5:leaf_death:"
                                 "2,9:link_degrade:dcn")
    inj, ref = tres.FaultInjector(plan), jres.FaultInjector(
        jres.parse_fault_plan("2:leaf_death:0,5:straggler:1,5:leaf_death:2,"
                              "9:link_degrade:dcn"))
    for step in (0, 1, 6, 3, 6, 20, 25):       # jumps forward and back
        got = [e.to_dict() for e in inj.fire(step)]
        assert got == [e.to_dict() for e in ref.fire(step)]
    assert inj.exhausted and inj.history() == ref.history()
    assert len(inj.fired) == len(plan)


# ---------------------------------------------------------------------------
# the chaos harness
# ---------------------------------------------------------------------------

def _assert_same_result(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("seed", range(8))
def test_chaos_result_is_the_references(seed):
    kw = dict(n_slots=3, n_pages=24, n_devices=4)
    plan = f"{1 + seed}:leaf_death:{seed % 4}" if seed % 4 else None
    if seed >= 4:
        plan = list(jres.FaultPlan.random(seed, 25, 4,
                                          n_deaths=1 + seed % 3).events)
        tplan = [tres.FaultEvent(**e.to_dict()) for e in plan]
    else:
        tplan = plan
    want = jres.run_chaos(8, seed=seed, plan=plan, **kw)
    got = tres.run_chaos(8, seed=seed, plan=tplan, **kw)
    _assert_same_result(got, want)
    clean = tres.run_chaos(8, seed=seed, **kw)
    _assert_same_result(clean, jres.run_chaos(8, seed=seed, **kw))
    for rid, toks in got.completed.items():
        assert toks == clean.completed[rid]


@st.composite
def chaos_streams(draw):
    n_req = draw(st.integers(1, 8))
    reqs = [(draw(st.integers(1, 8)), draw(st.integers(1, 6)))
            for _ in range(n_req)]
    n_devices = draw(st.integers(2, 4))
    n_deaths = draw(st.integers(0, n_devices - 1))
    seed = draw(st.integers(0, 2 ** 16))
    return reqs, n_devices, n_deaths, seed


@given(chaos_streams())
@settings(max_examples=40, deadline=None)
def test_harness_matches_the_reference_under_random_plans(chaos):
    """Random streams x random plans (tests/test_property.py's strategy):
    the port's harness gives the reference's ``ChaosResult`` and the
    survivors' tokens of the clean run."""
    reqs, n_devices, n_deaths, seed = chaos

    def drive(mod, plan):
        h = mod.ChaosHarness(n_pages=24, n_devices=n_devices, plan=plan)
        for rid, (pl, gl) in enumerate(reqs):
            h.submit(rid, pl, gl)
        return h.run()
    jplan = (jres.FaultPlan.random(seed, 40, n_devices, n_deaths=n_deaths)
             if n_deaths else None)
    tplan = (tres.FaultPlan.random(seed, 40, n_devices, n_deaths=n_deaths)
             if n_deaths else None)
    got, want = drive(tres, tplan), drive(jres, jplan)
    _assert_same_result(got, want)
    clean = drive(tres, None)
    for rid, toks in got.completed.items():
        assert toks == clean.completed[rid]
    assert set(got.completed) | set(got.failed) == set(range(len(reqs)))


# ---------------------------------------------------------------------------
# the serving engine (tests/test_resilience.py:371-409 against the port)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models():
    cfg = jconfigs.get("qwen2-1.5b").smoke_config()
    params, _ = jtr.init(jax.random.PRNGKey(0), cfg, RULES)
    return cfg, params, tqwen.SMOKE, interop.transformer_params_from(
        jax.tree.map(np.asarray, params))


def _work(vocab):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, int(rng.integers(2, 7)),
                          dtype=np.int64).astype(np.int32),
             int(rng.integers(1, 5))) for _ in range(5)]


# the reference test's engine with pages of 2 tokens, so that requests
# span pages and the forced re-placement has co-access to place
ECFG = dict(n_slots=2, page_size=2, n_pages=24, max_pages_per_req=6,
            temperature=0.8, seed=0, replace_every=0, place_devices=4)


class JaxGumbel:
    """The reference engine's sampling noise, key by key."""

    def __init__(self, seed):
        self.base = jax.random.PRNGKey(seed)

    def gumbel(self, rid, pos, n):
        key = jax.random.fold_in(jax.random.fold_in(self.base, rid), pos)
        return torch.from_numpy(np.array(jax.random.gumbel(
            key, (n,), jax.numpy.float32)))


def _serve_port(plan=None, noise=None, **kw):
    _, _, cfg, params = _models()
    inj = tres.FaultInjector(tres.parse_fault_plan(plan)) if plan else None
    eng = ServingEngine(params, cfg, EngineConfig(**{**ECFG, **kw}),
                        injector=inj, device="cpu", noise=noise)
    for prompt, gen in _work(cfg.vocab):
        eng.submit(prompt, gen)
    return eng, eng.run()


def _serve_reference(plan=None, **kw):
    cfg, params, _, _ = _models()
    inj = jres.FaultInjector(jres.parse_fault_plan(plan)) if plan else None
    eng = JEngine(params, cfg, RULES, JEngineConfig(**{**ECFG, **kw}),
                  injector=inj)
    for prompt, gen in _work(cfg.vocab):
        eng.submit(prompt, gen)
    return eng.run()


def _tokens(report):
    return {r["rid"]: r["generated"] for r in report.requests}


RECORD = ("step", "device", "pages_lost", "requests_requeued",
          "requests_failed", "n_alive", "replaced")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_chaos_matches_clean_run_and_reference(temperature):
    plan = "4:leaf_death:1"
    _, clean = _serve_port(temperature=temperature)
    eng, chaos = _serve_port(plan, temperature=temperature)
    assert not chaos.failed and chaos.requests_failed == 0
    assert _tokens(chaos) == _tokens(clean)
    rec = chaos.recoveries[0]
    assert rec["device"] == 1 and rec["n_alive"] == 3 and rec["replaced"]
    assert chaos.faults[0]["kind"] == "leaf_death"
    assert "faults:" in chaos.summary()
    assert chaos.placements[-1]["tag"] == "leaf_death"
    # retired pages are zero in both pools
    dead = torch.as_tensor(eng.cache.allocator.dead_pages())
    assert dead.numel() == rec["pages_lost"] > 0
    for pool in (eng.cache.k_pool, eng.cache.v_pool):
        assert not bool(pool.index_select(1, dead).any())
    # against the reference engine: the recovery record and the tokens
    ref = _serve_reference(plan, temperature=temperature)
    noise = JaxGumbel(0) if temperature > 0 else None
    _, with_noise = _serve_port(plan, noise=noise, temperature=temperature)
    assert _tokens(with_noise) == _tokens(ref)
    assert [{k: r[k] for k in RECORD} for r in chaos.recoveries] == \
        [{k: r[k] for k in RECORD} for r in ref.recoveries]
    for f in ("n_requests", "steps", "tokens_out", "requests_retried",
              "requests_failed", "tokens_reprefilled"):
        assert getattr(chaos, f) == getattr(ref, f), f
    assert chaos.faults == ref.faults
    json.loads(chaos.to_json())


def test_engine_repeated_and_unknown_deaths_and_backoff():
    """A death on an already-dead or out-of-range device is logged and
    changes nothing; a second death shrinks the pool again; the stream
    still drains with the clean tokens."""
    _, clean = _serve_port(temperature=0.0)
    _, chaos = _serve_port("3:leaf_death:1,4:leaf_death:1,5:leaf_death:9,"
                           "6:leaf_death:2,6:straggler:0", temperature=0.0)
    assert [r["n_alive"] for r in chaos.recoveries] == [3, 2]
    assert len(chaos.faults) == 5
    assert _tokens(chaos) == {r: t for r, t in _tokens(clean).items()
                              if r in _tokens(chaos)}
    assert chaos.n_requests + chaos.requests_failed == 5


# ---------------------------------------------------------------------------
# the loop and the supervisor
# ---------------------------------------------------------------------------

def _toy_step(params, opt_state, batch):
    g = batch["x"].mean()
    params = {"w": params["w"] - 0.1 * g}
    return params, opt_state, {"loss": params["w"].sum() ** 2}


def _toy_factory(start):
    def gen():
        i = start
        while True:
            yield {"x": torch.full((4,), float(i + 1))}
            i += 1
    return gen()


def _params():
    return {"w": torch.ones(3)}


def test_device_failure_carries_partial_trajectory():
    inj = tres.FaultInjector(tres.FaultPlan((tres.FaultEvent(
        6, "leaf_death", 0), tres.FaultEvent(2, "straggler", 1, 0.5))))
    with pytest.raises(tres.DeviceFailure) as exc:
        loop.run(_toy_step, _params(), None, _toy_factory(0),
                 loop.LoopConfig(total_steps=10), injector=inj)
    assert len(exc.value.losses) == 6 and exc.value.start_step == 0
    assert exc.value.event.target == 0


def test_straggler_events_are_counted():
    inj = tres.FaultInjector(tres.parse_fault_plan(
        "1:straggler:0,3:straggler:1"))
    _, _, res = loop.run(_toy_step, _params(), None, _toy_factory(0),
                         loop.LoopConfig(total_steps=6), injector=inj)
    assert res.straggler_steps >= 2 and res.steps_run == 6


@pytest.mark.parametrize("machine", [None, "tpu_v5e-256"])
def test_supervised_restart_is_the_uninterrupted_run(tmp_path, machine):
    _, _, clean = loop.run(_toy_step, _params(), None, _toy_factory(0),
                           loop.LoopConfig(total_steps=12, ckpt_every=4))
    cfg = loop.LoopConfig(total_steps=12, ckpt_every=4,
                          ckpt_dir=str(tmp_path))
    plan = tres.FaultPlan((tres.FaultEvent(7, "leaf_death", 1),))
    p, _, sup = loop.run_supervised(_toy_step, _params(), None,
                                    _toy_factory, cfg, plan, machine=machine)
    assert sup.attempts == 2 and sup.steps_run == 12
    assert sup.recoveries[0]["resumed_from"] == 4
    assert sup.recoveries[0]["losses_kept"] == 4
    assert sup.losses == clean.losses              # bitwise
    if machine:
        assert sup.machine.n_alive == 255
    _, _, jsup = _reference_supervised(tmp_path / "ref", machine)
    np.testing.assert_allclose(sup.losses, jsup.losses, rtol=1e-6)
    assert [{k: r[k] for k in ("step", "device", "resumed_from",
                               "losses_kept")} for r in sup.recoveries] == \
        [{k: r[k] for k in ("step", "device", "resumed_from",
                            "losses_kept")} for r in jsup.recoveries]


def _reference_supervised(path, machine):
    import jax.numpy as jnp

    from repro.train import loop as jloop

    def step(params, opt_state, batch):
        g = float(batch["x"].mean())
        params = {"w": params["w"] - 0.1 * g}
        return params, opt_state, {"loss": float(params["w"].sum()) ** 2}

    def factory(start):
        def gen():
            i = start
            while True:
                yield {"x": np.full((4,), float(i + 1), np.float32)}
                i += 1
        return gen()
    cfg = jloop.LoopConfig(total_steps=12, ckpt_every=4,
                           ckpt_dir=str(path))
    return jloop.run_supervised(
        step, {"w": jnp.ones((3,))}, None, factory, cfg,
        jres.FaultPlan((jres.FaultEvent(7, "leaf_death", 1),)),
        machine=machine)


def test_supervised_restart_budget_exhausts(tmp_path):
    cfg = loop.LoopConfig(total_steps=10, ckpt_every=4,
                          ckpt_dir=str(tmp_path))
    plan = tres.parse_fault_plan("2:leaf_death:0,5:leaf_death:1")
    with pytest.raises(tres.DeviceFailure) as exc:
        loop.run_supervised(_toy_step, _params(), None, _toy_factory, cfg,
                            plan, max_restarts=1)
    assert exc.value.event.step == 5
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_supervised_bare_iterator_and_no_checkpoint():
    """Without a checkpoint a death restarts from step 0 (nothing kept);
    a bare iterator is consumed forward across attempts."""
    plan = tres.parse_fault_plan("3:leaf_death:0")
    _, _, sup = loop.run_supervised(_toy_step, _params(), None,
                                    _toy_factory(0),
                                    loop.LoopConfig(total_steps=5), plan)
    assert sup.recoveries[0]["resumed_from"] == 0
    assert sup.recoveries[0]["losses_kept"] == 0
    assert sup.steps_run == 5 and sup.attempts == 2


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_serve_cli_recovers_on_the_cpu(capsys, monkeypatch):
    import sys
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
        "--place-devices", "4", "--num-requests", "6", "--gen-len", "8",
        "--fault-plan", "6:leaf_death:1"])
    tserve.main()
    out = capsys.readouterr().out
    assert "[SERVE] 6 requests" in out
    assert "[SERVE] faults: 1 event(s), 1 recover(ies)" in out
    assert "recovery step=6 device=1" in out and "n_alive=3" in out


def test_train_cli_supervised_on_the_cpu(capsys, tmp_path):
    args = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--steps",
            "6", "--batch", "2", "--seq", "16", "--ckpt-every", "2"]
    tlaunch.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    clean = capsys.readouterr().out
    tlaunch.main(args + ["--ckpt-dir", str(tmp_path / "b"), "--fault-plan",
                         "3:leaf_death:1"])
    out = capsys.readouterr().out
    assert ("[TRAIN] recovery: device 1 died at step 3; resumed from "
            "checkpoint 2") in out
    assert "steps=6 attempts=2 recoveries=1" in out
    # the stitched trajectory's ends are the clean run's
    ends = clean.split("loss ")[1].split(" (")[0]
    assert f"loss {ends}" in out
