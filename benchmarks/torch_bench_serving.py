"""Serving throughput on the port: continuous against static batching
through the paged KV cache at N concurrent mixed-length streams
(tokens/s, p50/p99 latency and TTFT in decode steps), continuous again
with the drift-triggered page placement on, and one leaf death
mid-stream. Twin of ``bench_serving.py`` over ``repro_torch``.

The same claims raise on failure: continuous batching takes no more
decode steps than static and keeps at least 0.9x its tokens/s; placement
leaves every sampled token as it was; under the death no request fails,
every token equals the clean run's, and the step overhead stays within
the replayed tokens plus backoff. The schedule (steps, tokens, latency
and TTFT in steps, occupancy) depends only on the workload and the
scheduler, so it equals the reference bench's row for row. The port's
engine takes no sharding rules: the reference bench passes ``lm_rules(())``,
the no-mesh rule set, which replicates everything.

``serving_throughput`` takes the model's config and weights; by default
the ``qwen2-1.5b`` SMOKE config with weights from seed 0, as the
reference bench runs it. Writes ``BENCH_torch_serving.json``. Run from
the repository's root:

    PYTHONPATH=src python -m benchmarks.torch_bench_serving
    REPRO_BENCH_DEVICE=cpu REPRO_BENCH_TINY=1 PYTHONPATH=src \\
        python -m benchmarks.torch_bench_serving
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmarks.torch_common import bench_device, emit, tiny
from repro_torch import configs, resolve_device
from repro_torch.models import transformer as tr
from repro_torch.resilience import FaultEvent, FaultInjector, FaultPlan
from repro_torch.serving import EngineConfig, ServingEngine

ARCH = "qwen2-1.5b"
# (requests, slots, longest prompt, longest generation), page size
SHAPE = tiny((32, 8, 24, 16), (12, 4, 8, 6))
PAGE = tiny(8, 4)
# the fields that depend only on the workload and the scheduler
SCHEDULE = ("steps", "tokens_out", "latency_p50", "latency_p99",
            "ttft_p50", "ttft_p99", "occupancy")


def workload(vocab, n_req, max_prompt, max_gen, seed=0):
    """The reference bench's mixed-length stream: (prompt, generation
    length) pairs from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(2, max_prompt + 1)),
                          dtype=np.int64).astype(np.int32),
             int(rng.integers(1, max_gen + 1))) for _ in range(n_req)]


def _serve(params, cfg, work, dev, injector=None, **ecfg_kw):
    eng = ServingEngine(params, cfg, EngineConfig(**ecfg_kw),
                        injector=injector, device=dev)
    for prompt, gen in work:
        eng.submit(prompt, gen)
    return eng.run()


def _row(name, rep):
    emit("serving", name, rep.wall_s, steps=rep.steps,
         tok_per_sec=rep.tok_per_s, p50=rep.latency_steps_p50,
         p99=rep.latency_steps_p99, occupancy=rep.mean_batch_occupancy)
    return {"name": name, "serve_s": rep.wall_s,
            "tok_per_sec": rep.tok_per_s, "steps": rep.steps,
            "tokens_out": rep.tokens_out,
            "latency_p50": rep.latency_steps_p50,
            "latency_p99": rep.latency_steps_p99,
            "ttft_p50": rep.ttft_steps_p50,
            "ttft_p99": rep.ttft_steps_p99,
            "occupancy": rep.mean_batch_occupancy}


def _tokens(rep):
    return {r["rid"]: r["generated"] for r in rep.requests}


def default_model(dev):
    """(config, weights): ``qwen2-1.5b`` SMOKE from seed 0 on ``dev``."""
    cfg = configs.get(ARCH).smoke_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return cfg, tr.init(cfg, gen, device=dev)


def serving_throughput(cfg=None, params=None, device=None) -> list:
    """Continuous against static batching on the same stream, continuous
    with the page placement on, and a leaf death at a third of the clean
    run's steps; raises when a claim fails. Returns the four rows; the
    chaos row also holds ``failed``, the failed requests' count."""
    dev = resolve_device(device)
    if params is None:
        cfg, params = default_model(dev)
    n_req, slots, max_prompt, max_gen = SHAPE
    work = workload(cfg.vocab, n_req, max_prompt, max_gen)
    max_pages = -(-max(p.shape[0] + g for p, g in work) // PAGE)
    kw = dict(n_slots=slots, page_size=PAGE,
              n_pages=max_pages * slots * 2, max_pages_per_req=max_pages,
              temperature=0.8, seed=0)
    # warm-up, untimed: the whole stream, so that the timed runs meet no
    # batch shape for the first time (the reference warms one request,
    # which covers its one compiled step; eager PyTorch pays first-use
    # costs per shape, and they would land on the first timed run)
    _serve(params, cfg, work, dev, **kw)
    cont = _serve(params, cfg, work, dev, **kw)
    stat = _serve(params, cfg, work, dev, static_batching=True, **kw)
    placed = _serve(params, cfg, work, dev, replace_every=8,
                    place_devices=4, **kw)
    if cont.steps > stat.steps:
        raise AssertionError(
            f"continuous batching took {cont.steps} steps, static only "
            f"{stat.steps}: admission is broken")
    if cont.tok_per_s < 0.9 * stat.tok_per_s:
        raise AssertionError(
            f"continuous {cont.tok_per_s} tok/s fell behind static "
            f"{stat.tok_per_s} tok/s at {slots} concurrent streams")
    if _tokens(placed) != _tokens(cont):
        raise AssertionError("page re-placement changed the sampled "
                             "tokens: placement must be transparent")
    rows = [_row(f"continuous_x{slots}", cont),
            _row(f"static_x{slots}", stat),
            _row(f"continuous_placed_x{slots}", placed)]
    rows[2]["replacements"] = sum(1 for p in placed.placements
                                  if p["replaced"])

    death_step = max(2, cont.steps // 3)
    plan = FaultPlan((FaultEvent(death_step, "leaf_death", 1),))
    chaos = _serve(params, cfg, work, dev, replace_every=8, place_devices=4,
                   injector=FaultInjector(plan), **kw)
    if chaos.failed:
        raise AssertionError(
            f"{len(chaos.failed)} feasible request(s) failed under one "
            f"leaf death with retries available: {chaos.failed}")
    if _tokens(chaos) != _tokens(cont):
        raise AssertionError("leaf-death recovery changed the sampled "
                             "tokens: replay determinism is broken")
    slack = 8 * chaos.requests_retried + 8   # backoff + admission refill
    if chaos.steps > cont.steps + chaos.tokens_reprefilled + slack:
        raise AssertionError(
            f"recovery overhead blew past the replayed work: "
            f"{chaos.steps} steps vs clean {cont.steps} + "
            f"{chaos.tokens_reprefilled} re-prefilled + {slack} slack")
    rows.append(_row(f"chaos_death_x{slots}", chaos))
    rows[3].update(
        requests_retried=chaos.requests_retried,
        tokens_reprefilled=chaos.tokens_reprefilled,
        recovery_sec=round(sum(r["recovery_s"]
                               for r in chaos.recoveries), 4),
        step_overhead=chaos.steps - cont.steps, death_step=death_step,
        failed=len(chaos.failed))
    return rows


def run() -> None:
    dev = bench_device()
    rows = serving_throughput(device=dev)
    out = {"device": str(dev), "serving": rows,
           "tiny": os.environ.get("REPRO_BENCH_TINY", "") == "1"}
    with open("BENCH_torch_serving.json", "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote BENCH_torch_serving.json ({len(rows)} rows)")


if __name__ == "__main__":
    run()
