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

Fault injection (the reference's ``injector``, its leaf-death recovery)
waits for the resilience slice: an engine given an injector raises.
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

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    def summary(self) -> str:
        return (f"[SERVE] {self.n_requests} requests in {self.steps} "
                f"steps / {self.wall_s:.2f}s -> {self.tokens_out} tokens "
                f"({self.tok_per_s:.1f} tok/s) "
                f"latency p50/p99 = {self.latency_steps_p50:.0f}/"
                f"{self.latency_steps_p99:.0f} steps, ttft p50/p99 = "
                f"{self.ttft_steps_p50:.0f}/{self.ttft_steps_p99:.0f}, "
                f"occupancy {self.mean_batch_occupancy:.2f}, "
                f"replacements "
                f"{sum(1 for p in self.placements if p['replaced'])}")


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
    placement policy is on); ``noise`` replaces the default
    :class:`TorchGumbel` sampling noise. ``step_s`` holds each decode
    step's wall seconds."""

    def __init__(self, params, cfg, ecfg: EngineConfig,
                 session: Optional[Any] = None,
                 injector: Optional[Any] = None, device: DeviceLike = None,
                 noise: Optional[GumbelSource] = None):
        if injector is not None:
            raise NotImplementedError(
                "fault injection waits for the resilience slice of the port "
                "(ROADMAP.md, Queue 1 item 14)")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.cache = PagedKVCache(ecfg.n_pages, ecfg.page_size,
                                  ecfg.n_slots, ecfg.max_pages_per_req,
                                  cfg=cfg, device=self.device)
        self.scheduler = Scheduler(self.cache)
        self.session = session
        self.machine_spec = machine_lib.resolve(ecfg.machine)
        local = (torch.cuda.device_count() if self.device.type == "cuda"
                 else 1)
        self._n_devices = (self.machine_spec.n_alive
                           if self.machine_spec is not None
                           else (ecfg.place_devices or local))
        self.page_to_device: Optional[np.ndarray] = None
        self.placements: List[Dict[str, Any]] = []
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
        """One engine step: admit, batched decode, sample, advance."""
        t0 = time.perf_counter()
        ecfg = self.ecfg
        self.scheduler.admit(self._step,
                             only_when_idle=ecfg.static_batching)
        inputs = self.scheduler.step_inputs()
        if not inputs:
            if self.scheduler.queue:
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
            self._replace()
        self.step_s.append(time.perf_counter() - t0)

    def run(self) -> ServeReport:
        """Drain the queue; return the stream report."""
        t0 = time.time()
        while self.scheduler.has_work():
            self.step()
        return self._report(time.time() - t0)

    # -- placement policy ------------------------------------------------

    def _replace(self) -> bool:
        traffic = self.cache.page_traffic()
        if traffic.sum() <= 0:
            return False
        if self.session is None:
            from repro_torch.launch.placement import PlacementSession
            self.session = PlacementSession(device=self.device)
        placement = self.session.map_pages(
            traffic, node_weight=self.cache.page_weight(),
            n_devices=self._n_devices, machine=self.machine_spec,
            current=self.page_to_device)
        apply = (self.page_to_device is None
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
            "tag": "epoch"})
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
            } for r in done])
