#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the partitioner on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each, all of them on every run; any failure exits
non-zero:

  env      torch/CUDA versions and the card's name and power limit;
  build    nvcc over ``src/repro_torch/csrc/*.cu`` (all sources in
           parallel), with each kernel's -Xptxas -v register / shared
           memory / spill lines;
  kernels  every kernel against its plain PyTorch version on the card, at
           the main path's shapes and at a ragged one, with the device time
           of the kernel, of the plain version and of one PyTorch call
           computing the same function where there is one (L2 flushed
           before each call; ``warm_ms`` without the flush), the time per
           back-to-back call with the host's launch cost (``call_ms``), and
           the least time the H100 could take for the same bytes and
           operations;
  full     ``partition(grid3d(64, 64, 64), gpu-superpod, backend="device")``
           cold, warm, and once more under torch.profiler (device busy
           time, idle share and top kernels, all from that one traced
           run); the warm run's makespan is re-evaluated on the host and
           held to 1.05x the reference's worst device-backend makespan
           over seeds 0-3; ``match_keys``, ``bucket_assign`` and
           ``quotient_link_loads`` must have launched in the warm run;
  small    ``_rmat(2000, 8000)`` on ``balanced_tree((2, 4))``, host
           backend, then the device backend with the launch counts set to
           0 just before it: the path-walking oracle (``verify``) must pass
           for both, the device backend must be within 1.05x of the host
           backend, and all four kernels (``partition_gain`` because every
           level is dense at k = 8) must have launched in the device run.

Then one line ``{"kernels": [...]}``: each kernel's launches on the path
that drives it (``full`` for all but ``partition_gain``, ``small`` for it),
its launches on both paths, and the kernels phase's numbers at the main
path's shape. Last, the result line ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 2 and prints no result; it never runs on the
CPU.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Worst makespan of the reference (JAX) device backend on the full phase's
# problem over seeds 0..3 (32593.5, 32584.5, 38457.0, 34573.5; jax 0.9.0 on
# a CPU), from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "from repro.core.machine import
#   MachineSpec; from repro.core.partitioner import PartitionConfig, partition;
#   from repro.graph.generators import grid3d; g = grid3d(64, 64, 64);
#   t = MachineSpec.preset('gpu-superpod').tree(); print(max(partition(g, t,
#   PartitionConfig(seed=s, backend='device')).makespan for s in range(4)))"
# The seed alone moves the reference by up to 18%, so the band is taken
# over seeds, not at one seed.
REF_DEVICE_MAKESPAN_MAX = 38457.0
QUALITY_BAND = 1.05

# NVIDIA H100 SXM data sheet: HBM3 bytes/s and float32 (non-tensor) FLOP/s
H100_BYTES_PER_S = 3.35e12
H100_F32_PER_S = 67e12

# name: (source, the TPU kernel it replaces, the driven path that runs it;
# partition_gain needs dense levels, n*k <= 200,000, which the full cell
# never reaches at k = 64)
KERNEL_INFO = {
    "match_keys": ("src/repro_torch/csrc/match_keys.cu",
                   "src/repro/kernels/match_keys.py:60", "full"),
    "bucket_assign": ("src/repro_torch/csrc/bucket_assign.cu",
                      "src/repro/kernels/bucket_assign.py:69", "full"),
    "quotient_link_loads": ("src/repro_torch/csrc/quotient_link_loads.cu",
                            "src/repro/kernels/quotient_link_loads.py:99",
                            "full"),
    "partition_gain": ("src/repro_torch/csrc/partition_gain.cu",
                       "src/repro/kernels/partition_gain.py:67", "small"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events over
    ``iters`` warm calls)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, flush=None) -> float:
    """Mean device milliseconds per call of ``fn``, host launch cost left
    out: before each call the stream is stalled (``torch.cuda._sleep``)
    while the host queues the call, so the two events around it time only
    the device's work. ``flush`` (a large buffer) is read before each call
    to evict the 50 MB L2 (read, not written, so no dirty lines are left to
    write back during the call), so inputs come from device memory as the
    bound assumes; without it the inputs stay in L2 between calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        if flush is not None:
            flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def device_busy_and_span(prof):
    """(busy, span) seconds of the device events (kernels, copies,
    memsets) of one torch.profiler run: the union of their intervals, and
    the time from the first one's start to the last one's end."""
    import torch
    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in iv:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = (end - iv[0][0]) if iv else 0.0
    return busy / 1e6, span / 1e6


def bound(bytes_moved: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 peak."""
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rmat_graph(n, m, seed=0):
    """The reference tests' random multigraph (tests/test_device_vcycle.py)."""
    import numpy as np

    from repro_torch.graph.graph import from_edges
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, m)
    v = rng.integers(0, n, m)
    w = rng.random(m).astype(np.float32) + 0.1
    nw = rng.random(n).astype(np.float32) + 0.5
    return from_edges(n, u, v, w, nw)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env(state):
    import torch
    smi = nvidia_smi_line()
    print(smi, flush=True)
    state["smi"] = smi
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)


def phase_build(state):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    rep = build.build_all()
    emit("build", seconds=time.perf_counter() - t0, built=rep["built"],
         ptxas=rep["ptxas"])


def _check_kernel(state, name, shape, kern, plain, exact, rtol=0.0, atol=0.0,
                  iters=30, library=None, bytes_moved=0.0, flops=0.0):
    import torch
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    if exact:
        ok = torch.equal(got, want)
    else:
        ok = torch.allclose(got, want, rtol=rtol, atol=atol)
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    row = dict(kernel=name, shape=shape, max_abs_err=err,
               tolerance="exact" if exact else f"rtol {rtol}, atol {atol}",
               ms=device_ms(kern, iters, flush=state["flush"]),
               plain_ms=device_ms(plain, iters, flush=state["flush"]),
               library_ms=(None if library is None
                           else device_ms(library, iters, flush=state["flush"])),
               warm_ms=device_ms(kern, iters),
               plain_warm_ms=device_ms(plain, iters),
               call_ms=cuda_ms(kern, iters),
               plain_call_ms=cuda_ms(plain, iters))
    row["bound_ms"], row["bound_by"] = bound(bytes_moved, flops)
    emit("kernels", **row)
    if not ok:
        raise AssertionError(f"{name} {shape}: kernel disagrees with its "
                             f"plain version (max abs err {err})")
    rows = state.setdefault("kernel_rows", {}).setdefault(name, [])
    rows.append(row)


def phase_kernels(state):
    import numpy as np
    import torch

    from repro_torch.core.machine import MachineSpec
    from repro_torch.core.topology import production_tree
    from repro_torch.graph.generators import grid3d
    from repro_torch.kernels import (bucket_assign, match_keys, ops,
                                     partition_gain, quotient_link_loads)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # 256 MB, read before each timed call to evict the 50 MB L2
    state["flush"] = torch.ones(64 << 20, dtype=torch.int32, device=dev)

    # match_keys: level 0 of the full phase (1,548,288 arcs), and ragged
    for m in (1_548_288, 10_001):
        w = torch.rand(m, generator=gen, device=dev) + 0.5
        u = torch.rand(m, generator=gen, device=dev)
        mask = (torch.rand(m, generator=gen, device=dev) > 0.4).float()
        _check_kernel(state, "match_keys", [m],
                      lambda: match_keys.match_keys(w, u, mask),
                      lambda: match_keys.plain(w, u, mask), exact=True,
                      bytes_moved=16.0 * m, flops=3.0 * m)

    # bucket_assign: the coarsest level of the full phase (~12.4k vertices,
    # k = 64), and k = 257
    for n, k in ((12_400, 64), (12_401, 257)):
        nw = torch.rand(n, generator=gen, device=dev) + 0.1
        cum = torch.cumsum(nw, 0) - 0.5 * nw
        bounds = (torch.arange(1, k, device=dev, dtype=torch.float64) / k
                  * float(nw.sum())).float()
        _check_kernel(state, "bucket_assign", [n, k],
                      lambda: bucket_assign.bucket_assign(cum, bounds, k),
                      lambda: bucket_assign.plain(cum, bounds, k), exact=True,
                      library=lambda: torch.searchsorted(bounds, cum,
                                                         right=True),
                      bytes_moved=8.0 * n + 4.0 * (k - 1),
                      flops=float(n) * (k - 1))

    # quotient_link_loads: the full phase's level-0 arcs on gpu-superpod
    # (k = 64, L = 72), and on production_tree(2, 16, 16) (k = 512)
    g = grid3d(64, 64, 64)
    s = torch.as_tensor(g.senders, device=dev)
    r = torch.as_tensor(g.receivers, device=dev)
    w = torch.as_tensor(g.edge_weight, device=dev)
    for label, topo in (("gpu-superpod", MachineSpec.preset("gpu-superpod").tree()),
                        ("production_tree(2,16,16)", production_tree(2, 16, 16))):
        k = topo.k
        part = torch.randint(0, k, (g.n_nodes,), generator=gen, device=dev,
                             dtype=torch.int32)
        S = torch.as_tensor(topo.subtree, device=dev)
        F = torch.as_tensor(topo.F_l, device=dev)
        nnz_rows = float(np.count_nonzero(topo.subtree))
        m = g.n_arcs
        _check_kernel(
            state, "quotient_link_loads", [m, k, topo.n_links, label],
            lambda: quotient_link_loads.quotient_link_loads(part, s, r, w, S,
                                                            F, k),
            lambda: quotient_link_loads.plain(part, s, r, w, S, F, k),
            exact=False, rtol=1e-4, atol=1e-3,
            bytes_moved=12.0 * m + 4.0 * g.n_nodes + 4.0 * S.numel()
            + 8.0 * topo.n_links,
            flops=float(m) + 4.0 * k * nnz_rows + 2.0 * topo.n_links)

    # partition_gain: the small phase's level 0 (every level is dense at
    # k = 8), and a ragged row count
    for n, m in ((2000, 8000), (1001, 5003)):
        gs = rmat_graph(n, m, seed=0)
        k = 8
        idx, ew = ops.to_ell(gs.n_nodes, gs.senders, gs.receivers,
                             gs.edge_weight)
        nbr_idx = torch.as_tensor(idx, device=dev)
        nbr_w = torch.as_tensor(ew, device=dev)
        part = torch.randint(0, k, (gs.n_nodes,), generator=gen, device=dev,
                             dtype=torch.int32)
        d = idx.shape[1]
        _check_kernel(
            state, "partition_gain", [gs.n_nodes, d, k],
            lambda: partition_gain.partition_gain(part, nbr_idx, nbr_w, k),
            lambda: partition_gain.plain(part, nbr_idx, nbr_w, k),
            exact=False, rtol=1e-5, atol=1e-5,
            bytes_moved=8.0 * gs.n_nodes * d + 4.0 * gs.n_nodes
            + 4.0 * gs.n_nodes * k,
            flops=float(gs.n_arcs))


def host_makespan(g, topo, part):
    """Host numpy re-evaluation: np.add.at quotient + the S-XOR identity."""
    import numpy as np
    k = topo.k
    comp = np.bincount(part, weights=g.node_weight.astype(np.float64),
                       minlength=k)
    if topo.bin_speed is not None:
        comp = comp / topo.bin_speed
    W = np.zeros((k, k))
    np.add.at(W, (part[g.senders], part[g.receivers]),
              g.edge_weight.astype(np.float64))
    S = topo.subtree.astype(np.float64)
    cross = ((S @ W) * S).sum(1)
    comm = 0.5 * (S @ W.sum(1) + S @ W.sum(0) - 2.0 * cross)
    return max(comp.max(), (topo.F_l * comm).max())


def phase_full(state):
    import torch

    from repro_torch.core.machine import MachineSpec
    from repro_torch.core.partitioner import PartitionConfig, partition
    from repro_torch.graph.generators import grid3d
    from repro_torch.kernels import ops
    g = grid3d(64, 64, 64)
    topo = MachineSpec.preset("gpu-superpod").tree()
    cfg = PartitionConfig(seed=0, backend="device")

    t0 = time.perf_counter()
    partition(g, topo, cfg)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = partition(g, topo, cfg)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    counts = ops.launch_counts()
    state["launches"]["full"] = counts

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        partition(g, topo, cfg)
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0
    busy, span = device_busy_and_span(prof)
    dev_rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:8]
    # device seconds of the port's own kernels in the traced run
    own = {name: sum(e.self_device_time_total for e in dev_rows
                     if name in e.key or (name == "quotient_link_loads"
                                          and "qll_" in e.key)) / 1e6
           for name in KERNEL_INFO}

    host = host_makespan(g, topo, res.part)
    rel = abs(host - res.makespan) / host
    limit = QUALITY_BAND * REF_DEVICE_MAKESPAN_MAX
    emit("full", graph="grid3d(64,64,64)", n=g.n_nodes, arcs=g.n_arcs,
         machine="gpu-superpod", k=topo.k, links=topo.n_links,
         cold_s=cold, warm_s=warm, makespan=res.makespan,
         comp_max=res.comp_max, comm_max=res.comm_max,
         levels=len(res.level_makespans),
         # one traced run: its wall time (profiler overhead included, so
         # the idle share is an upper bound), the device's busy time and
         # the span from its first to its last device event
         profiled_s=profiled, device_busy_s=busy, device_span_s=span,
         device_idle_share=1.0 - busy / profiled,
         kernel_device_s=own,
         top_device=[[e.key, e.self_device_time_total / 1e6, e.count]
                     for e in top],
         host_makespan=host,
         host_rel_err=rel, limit=limit, launches=counts,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if rel > 1e-4:
        raise AssertionError(f"device makespan {res.makespan} != host "
                             f"re-evaluation {host}")
    if res.makespan > limit:
        raise AssertionError(f"makespan {res.makespan} above {limit}")
    _require_launched(counts, "full")


def _require_launched(counts, path):
    """The full path must launch its kernels; the small path all four."""
    for name, (_, _, kernel_path) in KERNEL_INFO.items():
        if (path == "small" or kernel_path == path) and counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the {path} path")


def phase_small(state):
    import torch

    from repro_torch.core.partitioner import PartitionConfig, partition, verify
    from repro_torch.core.topology import balanced_tree
    from repro_torch.kernels import ops
    g = rmat_graph(2000, 8000, seed=0)
    topo = balanced_tree((2, 4))
    t0 = time.perf_counter()
    host = partition(g, topo, PartitionConfig(seed=0))
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dev = partition(g, topo, PartitionConfig(seed=0, backend="device"))
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    state["launches"]["small"] = counts
    emit("small", graph="_rmat(2000,8000)", machine="balanced_tree((2,4))",
         host_makespan=host.makespan, device_makespan=dev.makespan,
         ratio=dev.makespan / host.makespan, host_s=host_s,
         device_s=device_s, launches=counts)
    verify(g, topo, host)
    verify(g, topo, dev)
    if dev.makespan > QUALITY_BAND * host.makespan:
        raise AssertionError(f"device {dev.makespan} above {QUALITY_BAND}x "
                             f"host {host.makespan}")
    _require_launched(counts, "small")


PHASES = (phase_env, phase_build, phase_kernels, phase_full, phase_small)


def kernels_line(state):
    """The per-kernel summary: launches on the path that drives the kernel
    (and on each path), and the numbers of its first (main-path) shape."""
    out = []
    for name, (source, replaces, path) in KERNEL_INFO.items():
        rows = state["kernel_rows"][name]
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            path=path, launches=state["launches"][path][name],
            launches_by_path={p: c[name]
                              for p, c in state["launches"].items()},
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=rows[0]["ms"], plain_ms=rows[0]["plain_ms"],
            bound_ms=rows[0]["bound_ms"], bound_by=rows[0]["bound_by"],
            library_ms=rows[0]["library_ms"]))
    return {"kernels": out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "GPU and never falls back to the CPU", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here when run outside the repo)

    state = {"launches": {}}
    for phase in PHASES:
        phase(state)
    print(json.dumps(kernels_line(state)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
