"""Fault tolerance: deterministic fault injection and the recovery paths
it exercises. Twin of ``repro/resilience``.

  * ``faults``  — :class:`FaultPlan` (a seeded, step-indexed schedule of
                  leaf death, link-bandwidth degradation and straggler
                  events) and :class:`FaultInjector`, which fires the plan
                  deterministically against a running stream or train
                  loop.
  * ``harness`` — a host-only chaos driver (scheduler + paged cache, no
                  decode, no device) for the property tests.

The recovery paths live with their owners: ``core.machine.MachineSpec.
degrade`` (dead leaves masked out of the scored topology),
``serving.ServingEngine`` (page loss, bounded-retry requeue, re-placement
over the survivors) and ``train.loop.run_supervised`` (checkpoint restore
and a replayed batch stream).
"""
from repro_torch.resilience.faults import (DeviceFailure, FaultEvent,
                                           FaultInjector, FaultPlan,
                                           parse_fault_plan)
from repro_torch.resilience.harness import (ChaosHarness, ChaosResult,
                                            run_chaos)

__all__ = ["ChaosHarness", "ChaosResult", "DeviceFailure", "FaultEvent",
           "FaultInjector", "FaultPlan", "parse_fault_plan", "run_chaos"]
