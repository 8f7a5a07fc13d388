"""``python -m repro_torch.analysis`` — the static-analysis CLI and CI gate:
twin of ``python -m repro.analysis``.

Runs the kernel verifier over every registered CUDA launch plan, the
sharding lint over the lm/gnn/recsys profile representatives, the serving
lint (a synthetic request stream through the real scheduler, checking the
page-traffic matrix fed to the page mapper), and the fault-tolerance lint
(every preset degraded by a leaf death, plus a seeded chaos stream whose
survivors must match the clean run bit-for-bit); prints the findings,
optionally writes them as structured JSON (the CI artifact), and exits
nonzero when any finding reaches ``--severity`` (default ``error``).

    PYTHONPATH=src python -m repro_torch.analysis                  # full suite
    PYTHONPATH=src python -m repro_torch.analysis --suite kernels
    PYTHONPATH=src python -m repro_torch.analysis --suite serving
    PYTHONPATH=src python -m repro_torch.analysis --suite faults
    PYTHONPATH=src python -m repro_torch.analysis --suite embed
    PYTHONPATH=src python -m repro_torch.analysis --severity error \
        --json analysis_findings.json                        # the CI gate
    PYTHONPATH=src python -m repro_torch.analysis --arch qwen2-72b --no-trace

Fully static: no kernel build, no kernel execution, no accelerator (the
sharding suite traces on meta tensors) — safe to run anywhere the package
imports.
"""
from __future__ import annotations

import argparse
import sys
from typing import List

from repro_torch import analysis
from repro_torch.analysis import Finding

# family representatives the sharding suite lints by default; each is
# checked over every profile its arch declares (ArchDef.profiles)
DEFAULT_ARCHS = ("qwen2-1.5b", "gin-tu", "two-tower-retrieval")


def run_kernel_suite() -> List[Finding]:
    from repro_torch.analysis import kernels as akernels
    return akernels.verify_all()


def run_serving_suite() -> List[Finding]:
    """Drive a small synthetic request stream through the real serving
    scheduler + paged-cache bookkeeping (host-side only, no decode) and
    lint the page-traffic matrix it would hand
    ``PlacementSession.map_pages`` — the same ``lint_traffic`` invariants
    as device traffic: square, finite, symmetric, zero diagonal. A
    violation here means the serving layer feeds the mapper garbage."""
    import numpy as np

    from repro_torch.analysis import shard_lint
    from repro_torch.serving import PagedKVCache, Request, Scheduler
    findings: List[Finding] = []
    cache = PagedKVCache(n_pages=16, page_size=2, n_slots=3,
                         max_pages_per_req=8)
    sched = Scheduler(cache)
    rng = np.random.default_rng(0)
    for i in range(6):
        sched.submit(Request(
            rid=i, prompt=np.zeros(int(rng.integers(2, 9)), np.int32),
            max_new_tokens=int(rng.integers(1, 6))), step=0)
    step = 0
    while sched.has_work():
        sched.admit(step)
        inputs = sched.step_inputs()
        cache.record_access({si.slot: si.pos + 1 for si in inputs})
        for si in inputs:
            sched.advance(si.slot, step,
                          0 if si.needs_sample else None)
        try:
            sched.check_invariants()
        except AssertionError as exc:
            findings.append(Finding(
                "serving-invariant", "error", f"serving:step{step}",
                f"scheduler/cache invariant violated: {exc}"))
            return findings
        step += 1
    findings.extend(shard_lint.lint_traffic(cache.page_traffic(),
                                            subject="serving:page-traffic"))
    if cache.allocator.n_free != cache.n_pages:
        findings.append(Finding(
            "serving-leak", "error", "serving:drain",
            f"{cache.n_pages - cache.allocator.n_free} page(s) still "
            "owned after the stream drained"))
    return findings


def run_faults_suite() -> List[Finding]:
    """Fault-tolerance lint, host-side only:

    1. every machine preset is degraded by one leaf death and the
       resulting topology checked — partitioner bin count equals
       ``n_alive``, every surviving capacity strictly positive, cache
       token changed (stale placements cannot be served);
    2. a seeded chaos stream (real scheduler + cache, injected death)
       must complete every request bit-identical to the clean run, leak
       no pages (free + dead covers the drained pool) and hand the page
       mapper a lawful traffic matrix.
    """
    import numpy as np

    from repro_torch.analysis import shard_lint
    from repro_torch.core import machine as machine_lib
    from repro_torch.resilience import FaultEvent, FaultPlan, run_chaos
    findings: List[Finding] = []
    for name in machine_lib.MachineSpec.presets():
        spec = machine_lib.resolve(name)
        if spec.kind == "torus2d" or spec.n_devices < 2:
            continue
        deg = spec.degrade([FaultEvent(0, "leaf_death", 0)])
        topo = deg.topology()
        subject = f"faults:degrade:{name}"
        if len(topo.compute_bins) != deg.n_alive:
            findings.append(Finding(
                "fault-degrade", "error", subject,
                f"degraded topology exposes {len(topo.compute_bins)} "
                f"bins, expected n_alive={deg.n_alive}"))
        speed = topo.bin_speed
        if speed is not None and not (np.asarray(speed) > 0).all():
            findings.append(Finding(
                "fault-degrade", "error", subject,
                "degraded topology carries a non-positive bin speed — "
                "a dead leaf leaked into the partitioner"))
        if deg.cache_token() == spec.cache_token():
            findings.append(Finding(
                "fault-degrade", "error", subject,
                "degrade() left cache_token unchanged — placement "
                "caches would serve the dead machine's placements"))
    plan = FaultPlan((FaultEvent(4, "leaf_death", 1),))
    clean = run_chaos(6, seed=0, n_pages=24, plan=None)
    chaos = run_chaos(6, seed=0, n_pages=24, plan=plan)
    for rid, toks in chaos.completed.items():
        if toks != clean.completed.get(rid):
            findings.append(Finding(
                "fault-determinism", "error", f"faults:chaos:rid{rid}",
                "survivor tokens diverged from the clean run after an "
                "injected leaf death (replay determinism broken)"))
    if chaos.failed:
        findings.append(Finding(
            "fault-recovery", "error", "faults:chaos",
            f"{len(chaos.failed)} feasible request(s) failed under a "
            "single leaf death with retries available"))
    from repro_torch.resilience import ChaosHarness
    h = ChaosHarness(n_pages=24, plan=plan)
    rng = np.random.default_rng(0)
    for rid in range(6):
        h.submit(rid, int(rng.integers(2, 9)), int(rng.integers(1, 9)))
    h.run()
    alloc = h.scheduler.cache.allocator
    if alloc.n_free + alloc.n_dead != alloc.n_pages:
        findings.append(Finding(
            "serving-leak", "error", "faults:drain",
            f"{alloc.n_pages - alloc.n_free - alloc.n_dead} page(s) "
            "still owned after the chaos stream drained"))
    findings.extend(shard_lint.lint_traffic(
        h.scheduler.cache.page_traffic(), subject="faults:page-traffic"))
    return findings


def run_embed_suite() -> List[Finding]:
    """Embedding-subsystem lint, host-side only:
    a synthetic Zipf batch stream builds the row co-access graph, the
    shard plan's structural invariants are checked (permutation inverse,
    device-contiguity, capacity accounting), the co-access traffic matrix
    must be ``lint_traffic``-lawful, and a driven hot-row cache must hold
    every bookkeeping invariant and drain to zero pending updates."""
    import numpy as np

    from repro_torch import embed
    from repro_torch.analysis import shard_lint
    findings: List[Finding] = []
    rng = np.random.default_rng(0)
    V, E, D = 512, 16, 4
    ranks = np.arange(1, V + 1, dtype=np.float64)
    probs = ranks ** -1.1
    probs /= probs.sum()
    stats = embed.RowAccessStats(V)
    for _ in range(8):
        ids = rng.choice(V, size=(16, 8), p=probs)
        drop = rng.random(ids.shape) < 0.2
        stats.record(np.where(drop, -1, ids))
    plan = embed.plan_shards(stats, n_devices=D, device="cpu")
    try:
        plan.check()
    except AssertionError as exc:
        findings.append(Finding(
            "embed-plan", "error", "embed:plan",
            f"shard plan invariant violated: {exc}"))
        return findings
    if not np.array_equal(np.bincount(plan.row_to_device, minlength=D),
                          plan.shard_sizes):
        findings.append(Finding(
            "embed-plan", "error", "embed:plan",
            "shard_sizes disagrees with the row assignment"))
    findings.extend(shard_lint.lint_traffic(
        stats.device_traffic(plan.row_to_device, D),
        subject="embed:coaccess-traffic"))

    table = rng.normal(0, 0.1, (V, E)).astype(np.float32)
    st = embed.ShardedEmbeddingTable(table, plan)
    cache = embed.HotRowCache(st, n_cache=32, policy="lru")
    cache.warm(stats.top_rows(32))
    accum = np.zeros(V, np.float32)
    for _ in range(6):
        ids = rng.choice(V, size=48, p=probs)
        cache.lookup(ids)
        rows = np.unique(ids)
        grads = rng.normal(0, 1, (rows.shape[0], E)).astype(np.float32)
        accum = cache.apply_grads(rows, grads, accum)
        try:
            cache.check_invariants()
        except AssertionError as exc:
            findings.append(Finding(
                "embed-cache", "error", "embed:cache",
                f"hot-row cache invariant violated: {exc}"))
            return findings
    cache.flush()
    if cache.pending:
        findings.append(Finding(
            "embed-cache", "error", "embed:cache",
            f"{len(cache.pending)} pending update(s) survived flush()"))
    findings.extend(shard_lint.lint_traffic(
        cache.traffic, subject="embed:cache-traffic"))
    return findings


def run_sharding_suite(archs, *, trace: bool = True) -> List[Finding]:
    from repro_torch import configs
    from repro_torch.analysis import shard_lint
    findings: List[Finding] = []
    for arch_name in archs:
        arch = configs.get(arch_name)
        for profile in arch.profiles:
            findings.extend(shard_lint.lint_cell(arch_name,
                                                 profile=profile,
                                                 trace=trace))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static kernel/sharding verifier (no execution)")
    ap.add_argument("--suite",
                    choices=("all", "kernels", "sharding", "serving",
                             "faults", "embed"),
                    default="all")
    ap.add_argument("--severity", choices=analysis.SEVERITIES,
                    default="error",
                    help="exit nonzero when any finding is at or above "
                         "this severity (default: error)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write structured JSON findings (the CI artifact)")
    ap.add_argument("--arch", action="append", default=[],
                    help="arch(s) for the sharding suite (repeatable; "
                         f"default: {', '.join(DEFAULT_ARCHS)})")
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the meta trace (spec-tree lint only)")
    ap.add_argument("--quiet", action="store_true",
                    help="print only findings at/above --severity")
    args = ap.parse_args(argv)

    findings: List[Finding] = []
    if args.suite in ("all", "kernels"):
        findings.extend(run_kernel_suite())
    if args.suite in ("all", "sharding"):
        findings.extend(run_sharding_suite(args.arch or DEFAULT_ARCHS,
                                           trace=not args.no_trace))
    if args.suite in ("all", "serving"):
        findings.extend(run_serving_suite())
    if args.suite in ("all", "faults"):
        findings.extend(run_faults_suite())
    if args.suite in ("all", "embed"):
        findings.extend(run_embed_suite())

    shown = (analysis.at_least(findings, args.severity) if args.quiet
             else findings)
    print(analysis.format_findings(shown), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(analysis.to_json(findings,
                                     gate_severity=args.severity))
        print(f"[ANALYSIS] wrote {len(findings)} finding(s) to "
              f"{args.json}", flush=True)
    gating = analysis.at_least(findings, args.severity)
    if gating:
        print(f"[ANALYSIS] GATE FAILED: {len(gating)} finding(s) at or "
              f"above {args.severity!r}", flush=True)
        return 1
    print(f"[ANALYSIS] gate clean at severity {args.severity!r}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
