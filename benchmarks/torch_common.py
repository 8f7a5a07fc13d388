"""Shared helpers of the port's benchmark twins (``torch_bench_*.py``):
modelled step times and CSV emission, as ``benchmarks/common.py`` gives
the reference's benches, over ``repro_torch`` only.

``REPRO_BENCH_TINY=1`` shrinks every suite to smoke sizes. The twins run
on the card; ``REPRO_BENCH_DEVICE=cpu`` asks for the plain PyTorch path
instead.
"""
from __future__ import annotations

import os
import time
from typing import Dict

from repro_torch.core import baselines
from repro_torch.core.topology import TreeTopology

TINY = os.environ.get("REPRO_BENCH_TINY", "") == "1"


def tiny(full, small):
    """``full`` normally, ``small`` under REPRO_BENCH_TINY=1."""
    return small if TINY else full


def bench_device() -> str:
    """``$REPRO_BENCH_DEVICE``, else CUDA."""
    return os.environ.get("REPRO_BENCH_DEVICE", "cuda")


def emit(bench: str, name: str, seconds: float, **derived):
    """One CSV line: bench, row name, microseconds, derived values."""
    extras = " ".join(f"{k}={v}" for k, v in derived.items())
    print(f"{bench},{name},{round(seconds * 1e6, 1)},{extras}", flush=True)


def public(row: dict) -> dict:
    """A twin's row without what it scored (``scored``)."""
    return {k: v for k, v in row.items() if k != "scored"}


def spmv_step_time(g, topo: TreeTopology, part, device,
                   t_comp: float = 1.0,
                   t_byte: float = 1.0) -> Dict[str, float]:
    """Modelled SpMV iteration time (the paper's SpMV regime): compute and
    per-link communication overlap, so the step is the max over bins and
    links, M(P) with F = t_byte / t_comp."""
    s = baselines.score_all(g, topo, part, device=device)
    step = max(s["comp_max"] * t_comp, s["comm_max"] * t_byte)
    return {"step": step, **s}


def timed(fn, *args, **kw):
    """(result, wall seconds) of one call."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0
