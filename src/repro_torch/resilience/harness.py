"""Host-only chaos harness: drive the port's scheduler and paged-cache
bookkeeping through a fault plan with no model and no device. Twin of
``repro/resilience/harness.py`` (``synthetic_token``, ``ChaosHarness``,
``ChaosResult``, ``run_chaos``), over the port's ``Scheduler`` and a
``PagedKVCache(cfg=None)``, which allocates no pools.

The harness mirrors the engine loop exactly — admit, per-slot step
inputs, access recording, advance, and :meth:`Scheduler.handle_leaf_death`
on an injected death — but replaces the decode with a pure function of
``(rid, pos)``. That is the engine's determinism contract (sampling is a
function of ``(seed, rid, pos)`` only), so the harness proves the property
the card's path relies on: a request requeued by a death replays its
known tokens and continues identically to an uninterrupted run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.resilience.faults import FaultInjector, plan_from
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.scheduler import Request, Scheduler


def synthetic_token(rid: int, pos: int) -> int:
    """The stand-in for one sampled token: pure in ``(rid, pos)`` — the
    same key the engine folds into its PRNG — so replay determinism is
    checkable without a model."""
    return (rid * 1000003 + pos * 7919) % 50257


@dataclasses.dataclass
class ChaosResult:
    steps: int
    completed: Dict[int, List[int]]        # rid -> generated tokens
    failed: Dict[int, str]                 # rid -> fail reason
    retried: int                           # requests with >= 1 requeue
    recoveries: List[Dict[str, Any]]
    idle_steps: int                        # backoff-only idle steps


class ChaosHarness:
    """One serving stream + one fault plan, all host bookkeeping."""

    def __init__(self, *, n_slots: int = 4, page_size: int = 4,
                 n_pages: int = 32, max_pages_per_req: int = 8,
                 n_devices: int = 4, plan: Any = None,
                 max_retries: int = 3, backoff_base: int = 2):
        cache = PagedKVCache(n_pages, page_size, n_slots, max_pages_per_req)
        self.scheduler = Scheduler(cache)
        self.injector = FaultInjector(plan_from(plan))
        self.n_devices = n_devices
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.dead_devices: set = set()
        self.recoveries: List[Dict[str, Any]] = []
        # survivor-bin-space page assignment, balanced like the engine's
        self.page_to_device = (np.arange(n_pages) * n_devices) // max(
            n_pages, 1)

    # -- intake ----------------------------------------------------------

    def submit(self, rid: int, prompt_len: int, gen_len: int,
               step: int = 0) -> None:
        prompt = (np.arange(prompt_len, dtype=np.int64) % 101).astype(
            np.int32)
        self.scheduler.submit(
            Request(rid=rid, prompt=prompt, max_new_tokens=gen_len), step)

    # -- faults ----------------------------------------------------------

    def _rebalance(self) -> None:
        """Spread the surviving (non-retired) pages over the surviving
        bins — the mapper-free stand-in for ``map_pages`` re-placement."""
        n_alive = max(self.n_devices - len(self.dead_devices), 1)
        retired = set(self.scheduler.cache.allocator.dead_pages().tolist())
        live = [p for p in range(self.scheduler.cache.n_pages)
                if p not in retired]
        for i, p in enumerate(live):
            self.page_to_device[p] = (i * n_alive) // max(len(live), 1)

    def _leaf_death(self, target: int, step: int) -> None:
        if target in self.dead_devices or not (
                0 <= target < self.n_devices):
            return
        alive = [d for d in range(self.n_devices)
                 if d not in self.dead_devices]
        surv = alive.index(target)
        retired = set(self.scheduler.cache.allocator.dead_pages().tolist())
        dead_pages = [p for p in range(self.scheduler.cache.n_pages)
                      if self.page_to_device[p] == surv
                      and p not in retired]
        rec = self.scheduler.handle_leaf_death(
            dead_pages, step, max_retries=self.max_retries,
            backoff_base=self.backoff_base)
        self.dead_devices.add(target)
        # shift survivor indices past the dead one, then rebalance
        asg = self.page_to_device
        asg[asg == surv] = 0
        asg[asg > surv] -= 1
        self._rebalance()
        self.recoveries.append({
            "step": step, "device": target,
            "pages_lost": len(dead_pages),
            "requests_requeued": len(rec["requeued"]),
            "requests_failed": len(rec["failed"]),
            "n_alive": self.n_devices - len(self.dead_devices)})

    def _fire(self, step: int) -> None:
        for ev in self.injector.fire(step):
            if ev.kind == "leaf_death":
                self._leaf_death(int(ev.target), step)
            # link_degrade / straggler have no host-bookkeeping effect

    # -- the stream loop -------------------------------------------------

    def run(self, max_steps: int = 100_000) -> ChaosResult:
        sched = self.scheduler
        step = 0
        idle = 0
        while sched.has_work():
            if step > max_steps:
                raise RuntimeError(f"no progress after {max_steps} steps")
            self._fire(step)
            sched.admit(step)
            inputs = sched.step_inputs()
            if not inputs:
                # legitimate only while the queue head sits in backoff
                head = sched.queue[0] if sched.queue else None
                if head is None or head.not_before <= step:
                    raise RuntimeError(
                        f"idle at step {step} with admissible work")
                idle += 1
                step += 1
                continue
            sched.cache.record_access(
                {si.slot: si.pos + 1 for si in inputs})
            for si in inputs:
                tok: Optional[int] = None
                if si.needs_sample:
                    tok = synthetic_token(si.rid, si.pos)
                sched.advance(si.slot, step, tok)
            sched.check_invariants()
            step += 1
        done = sorted(sched.completed, key=lambda r: r.rid)
        return ChaosResult(
            steps=step,
            completed={r.rid: list(r.generated) for r in done},
            failed={r.rid: r.fail_reason for r in sched.failed},
            retried=sum(1 for r in done if r.retries),
            recoveries=self.recoveries,
            idle_steps=idle)


def run_chaos(n_requests: int = 8, *, seed: int = 0, plan: Any = None,
              **kwargs) -> ChaosResult:
    """One seeded stream through the harness: ``n_requests`` mixed-length
    requests, then run to drain. The workload is a pure function of
    ``seed``, so a clean run and a chaos run are directly comparable."""
    rng = np.random.default_rng(seed)
    h = ChaosHarness(plan=plan, **kwargs)
    for rid in range(n_requests):
        h.submit(rid, int(rng.integers(2, 9)), int(rng.integers(1, 9)))
    return h.run()
