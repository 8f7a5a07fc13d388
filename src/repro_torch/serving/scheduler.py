"""Continuous-batching scheduler: FIFO admit, completion evict, page
backpressure. Pure host bookkeeping, a copy of
``repro/serving/scheduler.py`` (``handle_leaf_death`` included), so random
request streams can be driven through the real code.

State machine per request (DESIGN.md §Serving, §Fault-tolerance):

    QUEUED --admit (slot free AND pages free)--> PREFILL
    PREFILL --one prompt token per step--> DECODE (first sampled token)
    DECODE --max_new_tokens sampled--> DONE (pages freed, slot freed)
    PREFILL/DECODE --leaf death hit its pages--> QUEUED (requeue: pages
        freed, pos reset, already-sampled tokens kept for replay) or
        FAILED (retries exhausted)
    QUEUED --pool shrank below its lifetime need--> FAILED (admit-time
        check: an infeasible head must never block the queue)

Admission is strictly FIFO and reserves every page of the request's
lifetime (``ceil((prompt + gen) / page_size)``) up front: the head of the
queue blocks until it fits, so nothing overtakes it (no starvation) and
an admitted request can always finish (no page deadlock). Each admitted
request advances exactly one token per engine step — during PREFILL the
fed token comes from the prompt, during DECODE from the previous sample —
so steps-to-first-token after admission is exactly ``prompt_len``.

Replay determinism: a requeued request re-prefills its prompt AND its
already-sampled tokens (``replay_gen``); sampling resumes at the first
*new* position. The engine keys sampling by ``(rid, pos)``, so the
resumed continuation is bit-identical to the uninterrupted one.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.kv_cache import PagedKVCache


@dataclasses.dataclass
class Request:
    """One serving request and its lifecycle trace (step indices are
    engine decode steps, -1 until reached)."""
    rid: int
    prompt: np.ndarray                 # [prompt_len] int32
    max_new_tokens: int
    submit_step: int = -1
    admit_step: int = -1
    first_token_step: int = -1
    done_step: int = -1
    slot: int = -1
    pos: int = 0                       # tokens already in the cache
    generated: List[int] = dataclasses.field(default_factory=list)
    # fault recovery (DESIGN.md §Fault-tolerance)
    retries: int = 0                   # requeues so far (bounded)
    replay_gen: int = 0                # sampled tokens being re-prefilled
    not_before: int = -1               # backoff: earliest re-admit step
    failed: bool = False
    fail_reason: str = ""
    fail_step: int = -1
    requeue_steps: List[int] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_tokens(self) -> int:
        return self.prompt_len + self.max_new_tokens

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def known_len(self) -> int:
        """Tokens whose values are already known (prompt + replayed
        samples): positions below this re-prefill, the rest sample."""
        return self.prompt_len + self.replay_gen


@dataclasses.dataclass(frozen=True)
class StepInput:
    """What one active slot feeds the batched decode this step."""
    slot: int
    rid: int
    token: int                         # seq[pos]: prompt or last sample
    pos: int                           # cache length before this step
    needs_sample: bool                 # logits of this step are consumed


class Scheduler:
    def __init__(self, cache: PagedKVCache):
        self.cache = cache
        self.n_slots = cache.n_slots
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}
        self.completed: List[Request] = []
        self.failed: List[Request] = []
        self._free_slots = list(range(cache.n_slots - 1, -1, -1))

    # -- intake ----------------------------------------------------------

    def submit(self, req: Request, step: int = 0) -> None:
        need = self.cache.pages_needed(req.total_tokens)
        if need > self.cache.max_pages_per_req:
            raise ValueError(
                f"request {req.rid}: {req.total_tokens} tokens need "
                f"{need} pages > max_pages_per_req="
                f"{self.cache.max_pages_per_req}")
        if need > self.cache.allocator.n_usable:
            raise ValueError(
                f"request {req.rid}: needs {need} pages, pool has "
                f"{self.cache.allocator.n_usable} usable — can never be "
                "admitted")
        if req.prompt_len < 1 or req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: prompt and gen lengths "
                             "must both be >= 1")
        req.submit_step = step
        self.queue.append(req)

    # -- per-step control ------------------------------------------------

    def admit(self, step: int, *, only_when_idle: bool = False
              ) -> List[Request]:
        """FIFO admission under slot + page backpressure. The head blocks
        the queue when it does not fit (no overtaking) — unless it can
        *never* fit: ``submit`` checked feasibility against the pool size
        at submit time, and a later degrade can shrink the pool below an
        already-queued request's lifetime need, so the head is re-checked
        here and failed (not blocked on) when it became infeasible. A
        requeued head in backoff (``not_before``) blocks the queue until
        its earliest re-admit step — FIFO is preserved, retries are not
        overtaken. With ``only_when_idle`` admission waits for an empty
        batch — the static-batching baseline the bench compares against."""
        admitted: List[Request] = []
        if only_when_idle and self.active:
            return admitted
        while self.queue:
            head = self.queue[0]
            if not self.cache.feasible(head.total_tokens):
                req = self.queue.popleft()
                need = self.cache.pages_needed(req.total_tokens)
                self._fail(req, step,
                           f"infeasible after degrade: needs {need} "
                           f"pages, pool has "
                           f"{self.cache.allocator.n_usable} usable")
                continue
            if not self._free_slots:
                break
            if head.not_before > step:
                break
            if not self.cache.can_admit(head.total_tokens):
                break
            req = self.queue.popleft()
            slot = self._free_slots.pop()
            self.cache.assign_slot(slot, req.total_tokens)
            req.slot = slot
            req.admit_step = step
            req.pos = 0
            self.active[slot] = req
            admitted.append(req)
        return admitted

    def step_inputs(self) -> List[StepInput]:
        """The token each active slot feeds this step (its ``pos``-th
        sequence token) and whether this step's logits get sampled.
        Positions below ``known_len`` (prompt, plus replayed samples
        after a requeue) re-prefill; sampling starts at the first new
        position."""
        out = []
        for slot in sorted(self.active):
            req = self.active[slot]
            if req.pos < req.prompt_len:
                token = int(req.prompt[req.pos])
            else:
                token = req.generated[req.pos - req.prompt_len]
            out.append(StepInput(slot=slot, rid=req.rid, token=token,
                                 pos=req.pos,
                                 needs_sample=req.pos + 1 >= req.known_len))
        return out

    def advance(self, slot: int, step: int,
                sampled: Optional[int] = None) -> Optional[Request]:
        """Consume one step for ``slot``: the fed token is now cached;
        ``sampled`` is this step's sampled token when the slot was in
        (or entering) DECODE. Returns the request when it completed (its
        pages are already back on the free list)."""
        req = self.active[slot]
        needed = req.pos + 1 >= req.known_len
        if needed != (sampled is not None):
            raise ValueError(f"slot {slot}: sample "
                             f"{'missing' if needed else 'unexpected'} at "
                             f"pos {req.pos}")
        req.pos += 1
        if sampled is not None:
            if req.first_token_step < 0:
                req.first_token_step = step
            req.generated.append(int(sampled))
            if req.done:
                req.done_step = step
                self.cache.release_slot(slot)
                del self.active[slot]
                self._free_slots.append(slot)
                req.slot = -1
                self.completed.append(req)
                return req
        return None

    # -- fault recovery --------------------------------------------------

    def _fail(self, req: Request, step: int, reason: str) -> None:
        req.failed = True
        req.fail_reason = reason
        req.fail_step = step
        self.failed.append(req)

    def requeue(self, slot: int, step: int, *,
                not_before: int = -1) -> Request:
        """Evict an active request back to the queue TAIL (untouched
        requests keep their FIFO positions): its pages are freed, its
        position resets, and its already-sampled tokens are kept for
        replay (``known_len``). ``not_before`` is the backoff gate the
        engine computes."""
        req = self.active.pop(slot)
        self.cache.release_slot(slot)
        self._free_slots.append(slot)
        req.slot = -1
        req.pos = 0
        req.replay_gen = len(req.generated)
        req.retries += 1
        req.requeue_steps.append(step)
        req.not_before = not_before
        self.queue.append(req)
        return req

    def evict_failed(self, slot: int, step: int, reason: str) -> Request:
        """Terminally fail an active request (retries exhausted): pages
        freed, slot freed, request lands in ``failed``."""
        req = self.active.pop(slot)
        self.cache.release_slot(slot)
        self._free_slots.append(slot)
        req.slot = -1
        self._fail(req, step, reason)
        return req

    def fail_infeasible(self, step: int) -> List[Request]:
        """Sweep the whole queue for requests the (shrunken) pool can
        never admit and fail them now — the degrade-time counterpart of
        the per-head check in :meth:`admit`."""
        kept: Deque[Request] = deque()
        swept: List[Request] = []
        for req in self.queue:
            if self.cache.feasible(req.total_tokens):
                kept.append(req)
            else:
                need = self.cache.pages_needed(req.total_tokens)
                self._fail(req, step,
                           f"infeasible after degrade: needs {need} "
                           f"pages, pool has "
                           f"{self.cache.allocator.n_usable} usable")
                swept.append(req)
        self.queue = kept
        return swept

    def handle_leaf_death(self, dead_pages: Sequence[int], step: int, *,
                          max_retries: int = 3,
                          backoff_base: int = 2) -> Dict[str, List[Request]]:
        """The shared recovery bookkeeping for one leaf death (engine and
        the host-only chaos harness both run exactly this):

        1. every active request holding a dying page is requeued with
           exponential backoff (``backoff_base * 2**retries`` steps), or
           terminally failed once it has been retried ``max_retries``
           times;
        2. the dead pages are retired from the pool (data zeroed by the
           cache layer);
        3. queued requests the shrunken pool can never fit are failed.

        Returns ``{"requeued": [...], "failed": [...]}``.
        """
        dead = set(int(p) for p in dead_pages)
        requeued: List[Request] = []
        failed: List[Request] = []
        for slot in sorted(self.active):
            pages = self.cache.slot_pages.get(slot, [])
            if not dead.intersection(pages):
                continue
            req = self.active[slot]
            if req.retries >= max_retries:
                failed.append(self.evict_failed(
                    slot, step, f"leaf death at step {step}: "
                    f"{max_retries} retries exhausted"))
            else:
                backoff = backoff_base * (2 ** req.retries)
                requeued.append(self.requeue(slot, step,
                                             not_before=step + backoff))
        self.cache.fail_pages(sorted(dead))
        failed.extend(self.fail_infeasible(step))
        return {"requeued": requeued, "failed": failed}

    # -- predicates ------------------------------------------------------

    def has_work(self) -> bool:
        return bool(self.queue or self.active)

    def check_invariants(self) -> None:
        """Structural invariants on top of the cache's: slot maps are
        mutually consistent and every active request holds exactly its
        reserved page count."""
        self.cache.check_invariants()
        live = self.cache.live_page_sets()
        if set(live) != set(self.active):
            raise AssertionError(f"cache slots {sorted(live)} != active "
                                 f"slots {sorted(self.active)}")
        for slot, req in self.active.items():
            need = self.cache.pages_needed(req.total_tokens)
            if len(live[slot]) != need:
                raise AssertionError(
                    f"slot {slot} holds {len(live[slot])} pages, "
                    f"reserved {need}")
        overlap = set(self._free_slots) & set(self.active)
        if overlap:
            raise AssertionError(f"slots both free and active: {overlap}")
