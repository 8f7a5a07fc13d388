"""Deterministic fault injection: plans, injectors, and the CLI format.
A copy of ``repro/resilience/faults.py`` (numpy only): the DSL, the JSON
form and ``FaultPlan.random``'s draws are the reference's bit for bit.

A :class:`FaultPlan` is a *seeded, step-indexed* schedule of fault events
— the chaos analogue of a workload trace. Determinism is the whole
point: the same plan against the same stream produces the same deaths at
the same steps, so recovery behaviour (which requests retry, which pages
are dropped, which tokens are re-prefilled) is reproducible and CI can
assert survivor tokens bit-identical to a clean run.

Three event kinds, mirroring the ways a machine diverges from its spec
(PAPERS.md, arXiv 2011.01814):

  * ``leaf_death``   — leaf ``target`` (an original device index) fails
                       permanently; its KV pages / mesh slot are gone.
  * ``link_degrade`` — the tree level named ``target`` drops to
                       ``factor`` × its nominal bandwidth (repriced into
                       the per-link cost factors ``F_l``).
  * ``straggler``    — leaf ``target`` slows to ``factor`` × its nominal
                       compute (folded into capacity-normalized loads).

Host-side numpy only — importable anywhere.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, List, Sequence, Tuple, Union

import numpy as np

KINDS = ("leaf_death", "link_degrade", "straggler")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``target`` is a leaf index for
    ``leaf_death``/``straggler`` and a tree-level name for
    ``link_degrade``; ``factor`` is the bandwidth/compute multiplier
    (ignored for ``leaf_death``)."""
    step: int
    kind: str
    target: Union[int, str]
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.kind == "link_degrade" and not isinstance(self.target, str):
            raise ValueError("link_degrade targets a tree level by name, "
                             f"got {self.target!r}")
        if self.kind in ("leaf_death", "straggler"):
            if not isinstance(self.target, (int, np.integer)):
                raise ValueError(f"{self.kind} targets a leaf index, "
                                 f"got {self.target!r}")
            object.__setattr__(self, "target", int(self.target))
        if self.kind != "leaf_death" and not (0.0 < self.factor <= 1.0):
            raise ValueError(f"{self.kind} factor must be in (0, 1], "
                             f"got {self.factor}")

    def to_dict(self) -> dict:
        return {"step": self.step, "kind": self.kind,
                "target": self.target, "factor": self.factor}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, step-sorted schedule of :class:`FaultEvent`s."""
    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        evs = tuple(sorted(self.events, key=lambda e: (e.step, e.kind,
                                                       str(e.target))))
        object.__setattr__(self, "events", evs)

    def __len__(self) -> int:
        return len(self.events)

    def at(self, step: int) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.step == step)

    def deaths(self) -> Tuple[int, ...]:
        return tuple(e.target for e in self.events
                     if e.kind == "leaf_death")

    @classmethod
    def random(cls, seed: int, n_steps: int, n_leaves: int, *,
               n_deaths: int = 1, n_link: int = 0, n_straggler: int = 0,
               levels: Sequence[str] = ()) -> "FaultPlan":
        """A seeded random plan: ``n_deaths`` distinct leaf deaths (never
        the whole machine), plus optional link/straggler events."""
        if n_deaths >= n_leaves:
            raise ValueError(f"cannot kill all {n_leaves} leaves")
        if n_link and not levels:
            raise ValueError("link events need level names")
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        dead = rng.choice(n_leaves, size=n_deaths, replace=False)
        for leaf in dead:
            events.append(FaultEvent(int(rng.integers(1, max(n_steps, 2))),
                                     "leaf_death", int(leaf)))
        for _ in range(n_link):
            events.append(FaultEvent(
                int(rng.integers(1, max(n_steps, 2))), "link_degrade",
                str(rng.choice(list(levels))),
                factor=float(rng.uniform(0.25, 0.75))))
        alive = [i for i in range(n_leaves) if i not in set(dead.tolist())]
        for _ in range(n_straggler):
            events.append(FaultEvent(
                int(rng.integers(1, max(n_steps, 2))), "straggler",
                int(rng.choice(alive)),
                factor=float(rng.uniform(0.3, 0.9))))
        return cls(tuple(events))

    def to_json(self) -> str:
        return json.dumps({"events": [e.to_dict() for e in self.events]},
                          indent=2)


class DeviceFailure(RuntimeError):
    """Raised into a run when an injected ``leaf_death`` fires somewhere
    the caller must unwind (the training loop). Carries the event; the
    supervisor attaches the partial loss trajectory for stitching."""

    def __init__(self, event: FaultEvent):
        super().__init__(f"injected leaf death: device {event.target} "
                         f"at step {event.step}")
        self.event = event
        self.losses: List[float] = []
        self.start_step: int = 0


class FaultInjector:
    """Fires a :class:`FaultPlan` deterministically against a stepped
    run. ``fire(step)`` returns (and consumes) every not-yet-fired event
    with ``event.step <= step`` — events are delivered exactly once even
    when the consumer's step counter jumps (e.g. a training run resuming
    from a checkpoint taken *before* the failure step must not replay
    the death)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._idx = 0
        self.fired: List[FaultEvent] = []

    def fire(self, step: int) -> List[FaultEvent]:
        out: List[FaultEvent] = []
        events = self.plan.events
        while self._idx < len(events) and events[self._idx].step <= step:
            ev = events[self._idx]
            self._idx += 1
            self.fired.append(ev)
            out.append(ev)
        return out

    @property
    def exhausted(self) -> bool:
        return self._idx >= len(self.plan.events)

    def history(self) -> List[dict]:
        return [e.to_dict() for e in self.fired]


def parse_fault_plan(spec: str) -> FaultPlan:
    """Parse the CLI ``--fault-plan`` value.

    Either a path to a JSON file (``{"events": [{"step":..., "kind":...,
    "target":..., "factor":...}, ...]}``) or an inline comma-separated
    DSL, one ``step:kind:target[:factor]`` per event::

        --fault-plan "6:leaf_death:1"
        --fault-plan "4:link_degrade:dcn:0.5,9:straggler:2:0.5"
    """
    spec = spec.strip()
    if spec.endswith(".json") or os.path.exists(spec):
        with open(spec) as f:
            raw = json.load(f)
        return FaultPlan(tuple(
            FaultEvent(step=int(e["step"]), kind=e["kind"],
                       target=e["target"],
                       factor=float(e.get("factor", 1.0)))
            for e in raw["events"]))
    events = []
    for item in spec.split(","):
        parts = item.strip().split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"bad fault event {item!r}: expected "
                "step:kind:target[:factor]")
        step, kind, target = int(parts[0]), parts[1], parts[2]
        factor = float(parts[3]) if len(parts) == 4 else (
            1.0 if kind == "leaf_death" else 0.5)
        if kind in ("leaf_death", "straggler"):
            target = int(target)
        events.append(FaultEvent(step=step, kind=kind, target=target,
                                 factor=factor))
    return FaultPlan(tuple(events))


def plan_from(obj) -> FaultPlan:
    """Coerce a plan-ish value: a FaultPlan, an iterable of events, or a
    CLI/JSON string."""
    if obj is None:
        return FaultPlan()
    if isinstance(obj, FaultPlan):
        return obj
    if isinstance(obj, str):
        return parse_fault_plan(obj)
    if isinstance(obj, Iterable):
        return FaultPlan(tuple(obj))
    raise TypeError(f"cannot build a FaultPlan from {type(obj).__name__}")
