"""The serving engine: continuous-batching stream loop over the paged
cache, with request metrics and drift-triggered page re-placement. Twin of
``repro/serving/engine.py`` (``EngineConfig``, ``ServeReport``,
``ServingEngine``).

One engine step = one batched ``paged_decode_step`` over every active
slot (mixed prompt/gen positions batch together), then per-slot
bookkeeping: prompt slots feed their next prompt token, decode slots
sample. Sampling is a function of ``(seed, rid, pos)`` only, so generated
tokens are identical regardless of batch composition, admission order or
slot count.

Sampling at a temperature is the Gumbel-max trick, as
``jax.random.categorical`` computes it: ``argmax(logits / T + g)`` with
``g`` standard Gumbel noise over the vocabulary. PyTorch cannot replay
``jax.random``, so the noise comes from a replaceable source (in the
manner of ``core/draws.py``): :class:`TorchGumbel`, a ``torch.Generator``
seeded from ``(seed, rid, pos)``, by default; a test can hand in the
reference's noise and demand the reference's tokens.

Placement: every ``replace_every`` steps the engine closes a traffic
epoch, feeds the measured page co-access graph to
``PlacementSession.map_pages`` (pages-as-rows, the paper's makespan
objective over the machine tree) and applies the returned page -> device
assignment — physically reordering the pool — when the current
placement's makespan on the NEW traffic exceeds the searched one by more
than ``drift_threshold``.

Fault recovery: with an ``injector`` (``resilience.FaultInjector``),
every step first fires the due fault events. A leaf death drops the KV
pages resident on the dead device (their pool rows zeroed, the pages
retired), requeues the affected requests through
``Scheduler.handle_leaf_death`` (bounded retries, exponential backoff,
FIFO kept for untouched requests), degrades the machine spec, and
force-re-places the surviving pages over the survivors with
``map_pages``. Because sampling is keyed by ``(seed, rid, pos)``, a
replayed request's continuation, and every survivor's output, is the
clean run's token for token.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Protocol

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import machine as machine_lib
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.paged_decode import paged_decode_step
from repro_torch.serving.scheduler import Request, Scheduler


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 4               # max concurrent streams
    page_size: int = 8             # tokens per KV page
    n_pages: int = 64              # physical pages in the pool
    max_pages_per_req: int = 16    # page-table width per slot
    temperature: float = 0.8       # 0 = greedy
    seed: int = 0                  # sampling seed (per-request folded)
    static_batching: bool = False  # admit only into an idle batch (bench)
    # -- placement policy --
    replace_every: int = 0         # steps per traffic epoch; 0 = off
    drift_threshold: float = 0.1   # re-place when old/new makespan > 1+thr
    place_devices: int = 0         # placement bins; 0 = CUDA device count
    machine: Optional[str] = None  # machine preset for the page topology
    # -- fault recovery --
    max_retries: int = 3           # requeues per request before FAILED
    retry_backoff: int = 2         # backoff steps: base * 2**retries


@dataclasses.dataclass
class ServeReport:
    """Stream-level metrics (JSON-native throughout)."""
    n_requests: int
    steps: int
    wall_s: float
    tokens_out: int
    tok_per_s: float
    latency_steps_p50: float       # submit -> done, in decode steps
    latency_steps_p99: float
    ttft_steps_p50: float          # submit -> first sampled token
    ttft_steps_p99: float
    mean_batch_occupancy: float    # active slots per step / n_slots
    placements: List[Dict[str, Any]]
    requests: List[Dict[str, Any]]
    # -- fault recovery (empty/zero on a clean run) --
    requests_retried: int = 0      # requests requeued at least once
    requests_failed: int = 0       # terminally FAILED requests
    tokens_reprefilled: int = 0    # tokens re-run because pages died
    recoveries: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)      # one record per leaf-death recovery
    faults: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)      # every injected event, as fired
    failed: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)      # FAILED request records with reasons

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    def summary(self) -> str:
        s = (f"[SERVE] {self.n_requests} requests in {self.steps} "
             f"steps / {self.wall_s:.2f}s -> {self.tokens_out} tokens "
             f"({self.tok_per_s:.1f} tok/s) "
             f"latency p50/p99 = {self.latency_steps_p50:.0f}/"
             f"{self.latency_steps_p99:.0f} steps, ttft p50/p99 = "
             f"{self.ttft_steps_p50:.0f}/{self.ttft_steps_p99:.0f}, "
             f"occupancy {self.mean_batch_occupancy:.2f}, "
             f"replacements "
             f"{sum(1 for p in self.placements if p['replaced'])}")
        if self.faults:
            s += (f"\n[SERVE] faults: {len(self.faults)} event(s), "
                  f"{len(self.recoveries)} recover(ies), "
                  f"{self.requests_retried} retried, "
                  f"{self.requests_failed} failed, "
                  f"{self.tokens_reprefilled} tokens re-prefilled")
        return s


class GumbelSource(Protocol):
    def gumbel(self, rid: int, pos: int, n: int) -> torch.Tensor:
        """[n] float32 standard Gumbel noise for request ``rid`` at token
        position ``pos``, on the engine's device."""


class TorchGumbel:
    """Gumbel noise from a ``torch.Generator`` on ``device`` seeded from
    ``(seed, rid, pos)`` alone: ``-log(-log(u))`` with ``u`` uniform on
    ``[tiny, 1)``, as ``jax.random.gumbel`` draws it."""

    def __init__(self, seed: int, device: torch.device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def gumbel(self, rid: int, pos: int, n: int) -> torch.Tensor:
        state = np.random.SeedSequence([self.seed, rid, pos]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(state >> np.uint64(1)))
        u = torch.rand(n, generator=gen, device=self.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))


class ServingEngine:
    """Ties scheduler + paged cache + the paged decode step into one stream
    loop on ``device`` (``None`` = CUDA). ``session`` is an optional
    ``launch.placement.PlacementSession`` (one is created lazily when the
    placement policy is on); ``injector`` fires a fault plan into the
    stream; ``noise`` replaces the default :class:`TorchGumbel` sampling
    noise. ``step_s`` holds each decode step's wall seconds."""

    def __init__(self, params, cfg, ecfg: EngineConfig,
                 session: Optional[Any] = None,
                 injector: Optional[Any] = None, device: DeviceLike = None,
                 noise: Optional[GumbelSource] = None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.cache = PagedKVCache(ecfg.n_pages, ecfg.page_size,
                                  ecfg.n_slots, ecfg.max_pages_per_req,
                                  cfg=cfg, device=self.device)
        self.scheduler = Scheduler(self.cache)
        self.session = session
        self.injector = injector
        # the machine model degrades as injected faults fire; map_pages
        # gets the object
        self.machine_spec = machine_lib.resolve(ecfg.machine)
        local = (torch.cuda.device_count() if self.device.type == "cuda"
                 else 1)
        self._n_devices0 = (self.machine_spec.n_devices
                            if self.machine_spec is not None
                            else (ecfg.place_devices or local))
        self._dead_devices: set = set()
        self.page_to_device: Optional[np.ndarray] = None
        self.placements: List[Dict[str, Any]] = []
        self.recoveries: List[Dict[str, Any]] = []
        self.fault_log: List[Dict[str, Any]] = []
        self._tokens_reprefilled = 0
        if injector is not None:
            # a death can fire before the first placement epoch; start
            # from balanced contiguous blocks so "pages on the dead
            # device" is defined from step 0
            n_dev = self._n_place_bins()
            self.page_to_device = ((np.arange(ecfg.n_pages) * n_dev)
                                   // max(ecfg.n_pages, 1))
        self.noise = noise if noise is not None else TorchGumbel(
            ecfg.seed, self.device)
        self.step_s: List[float] = []
        self._rid = 0
        self._step = 0
        self._occupancy: List[int] = []

    # -- intake ----------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> Request:
        req = Request(rid=self._rid,
                      prompt=np.asarray(prompt, dtype=np.int32),
                      max_new_tokens=int(max_new_tokens))
        self._rid += 1
        self.scheduler.submit(req, step=self._step)
        return req

    # -- the stream loop -------------------------------------------------

    def _sample(self, logits: torch.Tensor, inputs) -> Dict[int, int]:
        """slot -> sampled token for the slots whose logits are consumed:
        greedy ``argmax`` at temperature 0, else ``argmax(logits / T + g)``
        with ``g`` from the noise source for ``(rid, pos)``."""
        slots = [si.slot for si in inputs if si.needs_sample]
        if not slots:
            return {}
        rows = logits[torch.as_tensor(slots, device=logits.device)]
        temp = self.ecfg.temperature
        if temp <= 0:
            tok = torch.argmax(rows, dim=-1)
        else:
            noise = torch.stack([
                self.noise.gumbel(max(si.rid, 0), si.pos, rows.shape[-1])
                for si in inputs if si.needs_sample])
            tok = torch.argmax((rows / temp).to(noise.dtype) + noise, dim=-1)
        return dict(zip(slots, tok.cpu().tolist()))

    def step(self) -> None:
        """One engine step: fire due faults, admit, batched decode,
        sample, advance."""
        t0 = time.perf_counter()
        ecfg = self.ecfg
        if self.injector is not None:
            for ev in self.injector.fire(self._step):
                self._handle_fault(ev)
        self.scheduler.admit(self._step,
                             only_when_idle=ecfg.static_batching)
        inputs = self.scheduler.step_inputs()
        if not inputs:
            if self.scheduler.queue:
                if self.scheduler.queue[0].not_before > self._step:
                    # every queued request waits out its retry backoff:
                    # an idle step passes
                    self._occupancy.append(0)
                    self._step += 1
                    return
                raise RuntimeError(
                    "no active slot and the queue head cannot be "
                    "admitted — infeasible request escaped submit()")
            return
        n = self.cache.n_slots
        tokens = np.zeros((n, 1), dtype=np.int64)
        lengths = np.zeros((n,), dtype=np.int64)
        for si in inputs:
            tokens[si.slot, 0] = si.token
            lengths[si.slot] = si.pos
        dev = self.device
        logits = paged_decode_step(
            self.params, self.cache.k_pool, self.cache.v_pool,
            torch.as_tensor(self.cache.page_table, device=dev),
            torch.as_tensor(lengths, device=dev),
            torch.as_tensor(tokens, device=dev), self.cfg)
        sampled = self._sample(logits, inputs)
        # the step read pages [0, pos] of every active slot
        self.cache.record_access({si.slot: si.pos + 1 for si in inputs})
        self._occupancy.append(len(inputs))
        for si in inputs:
            self.scheduler.advance(si.slot, self._step,
                                   sampled.get(si.slot))
        self._step += 1
        if (ecfg.replace_every > 0
                and self._step % ecfg.replace_every == 0):
            self._replace(force=False, tag="epoch")
        self.step_s.append(time.perf_counter() - t0)

    def run(self) -> ServeReport:
        """Drain the queue; return the stream report."""
        t0 = time.time()
        while self.scheduler.has_work():
            self.step()
        return self._report(time.time() - t0)

    # -- fault recovery --------------------------------------------------

    def _n_place_bins(self) -> int:
        """Placement bins on the current machine: survivors only."""
        if self.machine_spec is not None:
            return self.machine_spec.n_alive
        return max(self._n_devices0 - len(self._dead_devices), 1)

    def _handle_fault(self, ev) -> None:
        self.fault_log.append(dict(ev.to_dict(), fired_step=self._step))
        if ev.kind == "leaf_death":
            self._recover_leaf_death(ev)
        elif self.machine_spec is not None:
            # link_degrade / straggler reprice the machine the next
            # map_pages scores against
            self.machine_spec = self.machine_spec.degrade([ev])

    def _recover_leaf_death(self, ev) -> None:
        """Drop the dead device's pages, requeue or fail their requests,
        shrink the machine, re-place the survivors."""
        t0 = time.time()
        target = int(ev.target)
        if target in self._dead_devices or not (
                0 <= target < self._n_devices0):
            return                     # already dead / unknown: no pages
        alive = [d for d in range(self._n_devices0)
                 if d not in self._dead_devices]
        surv_idx = alive.index(target)
        retired = set(self.cache.allocator.dead_pages().tolist())
        dead_pages = [int(p) for p in
                      np.nonzero(self.page_to_device == surv_idx)[0]
                      if p not in retired]
        res = self.scheduler.handle_leaf_death(
            dead_pages, self._step, max_retries=self.ecfg.max_retries,
            backoff_base=self.ecfg.retry_backoff)
        self._tokens_reprefilled += sum(
            r.prompt_len + r.replay_gen for r in res["requeued"])
        self._dead_devices.add(target)
        if self.machine_spec is not None:
            self.machine_spec = self.machine_spec.degrade([ev])
        # shift the live assignment into the survivors' index space (bins
        # above the dead one slide down; its own pages are retired and
        # carry no traffic: park them on bin 0)
        asg = self.page_to_device.copy()
        asg[asg == surv_idx] = 0
        asg[asg > surv_idx] -= 1
        self.page_to_device = asg
        # one forced re-placement of the surviving pages onto the shrunk
        # machine: a failure is drift at its most discontinuous
        replaced = self._replace(force=True, tag="leaf_death")
        self.recoveries.append({
            "step": self._step, "device": target,
            "pages_lost": len(dead_pages),
            "requests_requeued": len(res["requeued"]),
            "requests_failed": len(res["failed"]),
            "n_alive": self._n_place_bins(),
            "replaced": replaced,
            "recovery_s": round(time.time() - t0, 4)})

    # -- placement policy ------------------------------------------------

    def _replace(self, *, force: bool, tag: str) -> bool:
        traffic = self.cache.page_traffic()
        if traffic.sum() <= 0:
            return False
        if self.session is None:
            from repro_torch.launch.placement import PlacementSession
            self.session = PlacementSession(device=self.device)
        placement = self.session.map_pages(
            traffic, node_weight=self.cache.page_weight(),
            n_devices=self._n_place_bins(), machine=self.machine_spec,
            current=None if force else self.page_to_device)
        apply = (force or self.page_to_device is None
                 or placement.drift_ratio
                 > 1.0 + self.ecfg.drift_threshold)
        if apply:
            perm = self.cache.apply_placement(placement.page_to_device)
            moved = int((perm != np.arange(self.cache.n_pages)).sum())
            # relabel the assignment into the new physical order
            new_asg = np.empty_like(placement.page_to_device)
            new_asg[perm] = placement.page_to_device
            self.page_to_device = new_asg
            placement.replaced = True
        else:
            moved = 0
        self.placements.append({
            "step": self._step, "n_devices": placement.n_devices,
            "makespan": placement.makespan,
            "drift_ratio": (None if not np.isfinite(placement.drift_ratio)
                            else float(placement.drift_ratio)),
            "replaced": bool(placement.replaced), "pages_moved": moved,
            "tag": tag})
        self.cache.reset_traffic()
        return bool(apply)

    # -- metrics ---------------------------------------------------------

    def _report(self, wall_s: float) -> ServeReport:
        done = self.scheduler.completed
        lat = np.asarray([r.done_step - r.submit_step + 1 for r in done],
                         dtype=np.float64)
        ttft = np.asarray([r.first_token_step - r.submit_step + 1
                           for r in done], dtype=np.float64)
        tokens_out = int(sum(len(r.generated) for r in done))

        def pct(a, q):
            return float(np.percentile(a, q)) if a.size else 0.0

        occ = (float(np.mean(self._occupancy)) / self.cache.n_slots
               if self._occupancy else 0.0)
        failed = self.scheduler.failed
        return ServeReport(
            n_requests=len(done), steps=self._step,
            wall_s=round(wall_s, 4), tokens_out=tokens_out,
            tok_per_s=round(tokens_out / wall_s, 2) if wall_s > 0 else 0.0,
            latency_steps_p50=pct(lat, 50), latency_steps_p99=pct(lat, 99),
            ttft_steps_p50=pct(ttft, 50), ttft_steps_p99=pct(ttft, 99),
            mean_batch_occupancy=round(occ, 4),
            placements=list(self.placements),
            requests=[{
                "rid": r.rid, "prompt_len": r.prompt_len,
                "max_new_tokens": r.max_new_tokens,
                "submit_step": r.submit_step, "admit_step": r.admit_step,
                "first_token_step": r.first_token_step,
                "done_step": r.done_step, "generated": list(r.generated),
                "retries": r.retries,
                "requeue_steps": list(r.requeue_steps),
            } for r in done],
            requests_retried=sum(1 for r in done + failed if r.retries),
            requests_failed=len(failed),
            tokens_reprefilled=self._tokens_reprefilled,
            recoveries=list(self.recoveries),
            faults=list(self.fault_log),
            failed=[{
                "rid": r.rid, "prompt_len": r.prompt_len,
                "max_new_tokens": r.max_new_tokens,
                "retries": r.retries, "fail_step": r.fail_step,
                "fail_reason": r.fail_reason,
            } for r in failed])
