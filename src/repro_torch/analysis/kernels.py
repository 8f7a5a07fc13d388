"""Static CUDA-kernel verifier: prove launch, tiling and race properties of
a :class:`~repro_torch.kernels.plan.LaunchPlan` without launching a kernel.

Twin of ``repro/analysis/kernels.py``. Every launch in
``repro_torch.kernels`` passes the numbers of a plan built by its module's
``plan(...)`` to a C launcher that computes none of them, and the modules'
example plans are registered (``KERNEL_REGISTRY``), so a clean verdict
here is a proof about the executed launch, not about a description kept
beside it.

Checks (check id -> what a clean pass proves):

  * ``grid`` — 1 to 3 dims, each a positive static int within CUDA's
    limits (x <= 2**31 - 1, y and z <= 65,535).
  * ``block-threads`` — 1 to 3 positive dims of at most 1,024 threads in
    all (error); a whole number of warps (warning).
  * ``block-rank`` — one write map a output, one read map an operand, and
    every tile of the rank of its tensor.
  * ``index-purity`` — every read and write map evaluates under plain ints
    to plain int ranges.
  * ``block-bounds`` — every read and write tile lies inside its tensor; a
    written tile may overhang only an edge the plan declares masked (the
    twin of ``block-divisibility``).
  * ``coverage`` — every element of every output is written by some block
    (outputs are ``torch.empty``).
  * ``write-race`` — no two blocks write one element of an output that is
    not atomic, except in barrier-separated phases of a cooperative plan.
  * ``smem-budget`` — dynamic shared memory within the block limit with
    opt-in, and within 48 KB unless the plan opts in; the footprint is
    always reported (info), as ``vmem-budget`` is.
  * ``co-residency`` — a cooperative grid within SMs x the blocks an SM
    holds at the plan's threads, shared memory and ``min_blocks_per_sm``.
  * ``tma-descriptor`` — box dims <= 256, inner box bytes a multiple of 16
    and within the swizzle span, global strides multiples of 16 bytes,
    rank <= 5.
  * ``tiling-alignment`` (warning) — a declared 16-byte vector access has
    a row pitch and base offset that are multiples of 16.

Coverage and races are counted with numpy, one count per class of output
elements that the same tiles write (the tiles' boundaries cut every dim,
so the count is exact), up to ``MAX_CELLS`` classes an output. Grids of
more than ``max_grid_points`` blocks are verified on a per-axis boundary
sample (first, second, middle, last blocks), where coverage cannot be
proved, and an output past ``MAX_CELLS`` is not counted; both are
reported as ``grid-sampled`` info findings: sampling is never silent.
"""
from __future__ import annotations

import itertools
import math
import numbers
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis import Finding
from repro_torch.kernels import KERNEL_REGISTRY
from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels.plan import DeviceModel, LaunchPlan

MAX_GRID_POINTS = 65536
MAX_CELLS = 1 << 22
_BOUNDS_REPORTED = 8


def _is_static_int(v) -> bool:
    return (isinstance(v, numbers.Integral) and not isinstance(v, bool)) or (
        isinstance(v, np.generic) and np.issubdtype(v.dtype, np.integer))


def _grid_points(grid: Sequence[int], max_points: int
                 ) -> Tuple[List[Tuple[int, ...]], bool]:
    """All block indices, or a per-axis boundary sample when there are
    more than ``max_points``. Returns (points, sampled)."""
    if math.prod(grid) <= max_points:
        return list(itertools.product(*(range(g) for g in grid))), False
    axes = [sorted(x for x in {0, 1, g // 2, g - 2, g - 1} if 0 <= x < g)
            for g in grid]
    return list(itertools.product(*axes)), True


def _collect(fn, points, grid):
    """Every tile a map gives over ``points``: (flat block index [T], phase
    [T], ranges [T, D, 2]); raises ``TypeError`` on anything that is not
    int ranges, ``ValueError`` on ragged ranks."""
    blocks, phases, ranges = [], [], []
    for point in points:
        flat = int(np.ravel_multi_index(point, grid))
        for t in fn(*point):
            if isinstance(t, plan_lib.Tile):
                ranges.append(t.ranges)
                phases.append(t.phase)
            else:
                ranges.append(t)
                phases.append(0)
            blocks.append(flat)
    arr = np.asarray(ranges)
    if arr.size and (arr.ndim != 3 or arr.shape[2] != 2):
        raise ValueError("tiles are not (lo, hi) ranges of one rank")
    if arr.size and arr.dtype.kind not in "iu":
        raise TypeError(f"tile coordinates of dtype {arr.dtype}, not ints")
    ph = np.asarray(phases)
    if ph.size and ph.dtype.kind not in "iu":
        raise TypeError(f"tile phases of dtype {ph.dtype}, not ints")
    return (np.asarray(blocks, np.int64), ph.astype(np.int64),
            arr.astype(np.int64).reshape(len(blocks), -1, 2))


def _model(device) -> DeviceModel:
    if isinstance(device, DeviceModel):
        return device
    return plan_lib.device_model(device)


def _launch_checks(plan: LaunchPlan, model: DeviceModel, subject: str,
                   out: List[Finding]) -> bool:
    """grid, block-threads, smem-budget, co-residency, tma-descriptor and
    tiling-alignment; False where the grid cannot be enumerated."""
    grid = tuple(plan.grid)
    if not 1 <= len(grid) <= 3 or not all(
            _is_static_int(g) and int(g) >= 1 for g in grid):
        out.append(Finding("grid", "error", subject,
                           f"grid {plan.grid!r} of {plan.kernel} must be 1 "
                           "to 3 positive static ints",
                           {"kernel": plan.kernel}))
        return False
    over = [i for i, g in enumerate(grid) if int(g) > model.max_grid[i]]
    if over:
        out.append(Finding("grid", "error", subject,
                           f"grid {grid} of {plan.kernel} exceeds CUDA's "
                           f"limits {model.max_grid} on dims {over}",
                           {"kernel": plan.kernel, "dims": over}))
    threads = tuple(plan.threads)
    if not 1 <= len(threads) <= 3 or not all(
            _is_static_int(t) and int(t) >= 1 for t in threads):
        out.append(Finding("block-threads", "error", subject,
                           f"block {plan.threads!r} of {plan.kernel} must be "
                           "1 to 3 positive ints", {"kernel": plan.kernel}))
    else:
        n = math.prod(int(t) for t in threads)
        limits = (1024, 1024, 64)
        if n > model.max_threads_block or any(
                int(t) > lim for t, lim in zip(threads, limits)):
            out.append(Finding(
                "block-threads", "error", subject,
                f"block {threads} of {plan.kernel}: {n} threads, at most "
                f"{model.max_threads_block} (dims at most {limits})",
                {"kernel": plan.kernel, "threads": n}))
        elif n % 32:
            out.append(Finding(
                "block-threads", "warning", subject,
                f"block {threads} of {plan.kernel}: {n} threads are not a "
                "whole number of warps", {"kernel": plan.kernel,
                                          "threads": n}))
    smem = int(plan.dyn_smem)
    detail = {"kernel": plan.kernel, "dyn_smem": smem,
              "optin": bool(plan.smem_optin),
              "limit": model.smem_block_optin}
    if smem > model.smem_block_optin:
        out.append(Finding("smem-budget", "error", subject,
                           f"{plan.kernel}: {smem} B of dynamic shared "
                           f"memory exceed the {model.smem_block_optin} B a "
                           "block may opt in to", detail))
    elif smem > model.smem_block and not plan.smem_optin:
        out.append(Finding("smem-budget", "error", subject,
                           f"{plan.kernel}: {smem} B of dynamic shared "
                           f"memory exceed {model.smem_block} B without the "
                           "opt-in", detail))
    else:
        out.append(Finding("smem-budget", "info", subject,
                           f"{plan.kernel}: {smem} B of dynamic shared "
                           "memory within budget", detail))
    if plan.cooperative and all(_is_static_int(t) for t in threads):
        per_sm = model.resident_blocks(math.prod(threads), smem,
                                       plan.min_blocks_per_sm)
        if plan.blocks > per_sm * model.sms:
            out.append(Finding(
                "co-residency", "error", subject,
                f"cooperative {plan.kernel}: {plan.blocks} blocks exceed "
                f"{model.sms} SMs x {per_sm} resident blocks",
                {"kernel": plan.kernel, "blocks": plan.blocks,
                 "per_sm": per_sm, "sms": model.sms}))
    for m in plan.tma:
        bad = []
        item = plan_lib.ITEMSIZE[m.dtype]
        if not 1 <= len(m.dims) <= 5:
            bad.append(f"rank {len(m.dims)} outside 1..5")
        if len(m.box) != len(m.dims) or len(m.strides) != len(m.dims) - 1:
            bad.append("box / strides do not match the rank")
        if any(not 1 <= b <= 256 for b in m.box):
            bad.append(f"box {m.box} has a dim outside 1..256")
        inner = m.box[0] * item if m.box else 0
        if inner % 16:
            bad.append(f"inner box of {inner} B is not a multiple of 16")
        if m.swizzle and inner > m.swizzle:
            bad.append(f"inner box of {inner} B exceeds the {m.swizzle} B "
                       "swizzle span")
        if any(s % 16 for s in m.strides):
            bad.append(f"global strides {m.strides} are not multiples of "
                       "16 B")
        if bad:
            out.append(Finding("tma-descriptor", "error", subject,
                               f"{plan.kernel} tensor map {m.name}: "
                               + "; ".join(bad),
                               {"kernel": plan.kernel, "map": m.name}))
    for name, pitch, offset in plan.vectors:
        if pitch % 16 or offset % 16:
            out.append(Finding(
                "tiling-alignment", "warning", subject,
                f"{plan.kernel}: 16-byte vector access of {name} with row "
                f"pitch {pitch} B and base offset {offset} B",
                {"kernel": plan.kernel, "tensor": name}))
    return True


def _count(plan: LaunchPlan, i: int, shape, blocks, phases, lo, hi,
           sampled: bool, subject: str, out: List[Finding]) -> None:
    """coverage and write-race of output ``i`` from its tiles, clipped to
    the tensor (``lo``, ``hi`` [T, D]; the blocks' tiles are disjoint): the
    tiles' edges cut each dim into element classes, and a difference array
    counts the tiles over each class, per phase."""
    name = plan.outputs[i].name
    if math.prod(shape) == 0:
        return
    cuts = [np.unique(np.concatenate([[0, s], lo[:, d], hi[:, d]]))
            for d, s in enumerate(shape)]
    dims = tuple(len(c) - 1 for c in cuts)
    if math.prod(dims) > MAX_CELLS:
        out.append(Finding(
            "grid-sampled", "info", subject,
            f"{plan.kernel} output {name}: {math.prod(dims)} element classes "
            f"exceed {MAX_CELLS}; coverage and races not counted",
            {"kernel": plan.kernel, "output": name,
             "cells": math.prod(dims)}))
        return
    ilo = np.stack([np.searchsorted(c, lo[:, d]) for d, c in
                    enumerate(cuts)], axis=1) if len(lo) else lo
    ihi = np.stack([np.searchsorted(c, hi[:, d]) for d, c in
                    enumerate(cuts)], axis=1) if len(hi) else hi

    def counts(sel):
        diff = np.zeros(tuple(n + 1 for n in dims), np.int64)
        for corner in itertools.product((0, 1), repeat=len(dims)):
            at = tuple(np.where(bit, ihi[sel, d], ilo[sel, d])
                       for d, bit in enumerate(corner))
            np.add.at(diff, at, (-1) ** sum(corner))
        for d in range(len(dims)):
            diff = np.cumsum(diff, axis=d)
        return diff[tuple(slice(0, n) for n in dims)]

    covered = counts(np.arange(len(lo))) > 0
    if i not in plan.atomic_outputs:
        for ph in np.unique(phases):
            sel = np.nonzero(phases == ph)[0]
            over = counts(sel) > 1
            if not over.any():
                continue
            cell = np.argwhere(over)[0]
            inside = np.all((ilo[sel] <= cell) & (cell < ihi[sel]), axis=1)
            who = np.unique(blocks[sel][inside])[:2].tolist()
            at = [int(c[j]) for c, j in zip(cuts, cell)]
            out.append(Finding(
                "write-race", "error", subject,
                f"{plan.kernel}: blocks {who} both write output {name} at "
                f"{at} in phase {int(ph)}, which is neither atomic nor "
                "barrier-separated", {"kernel": plan.kernel, "output": name,
                                      "blocks": who, "element": at}))
            break
    if not sampled and not covered.all():
        missing = np.argwhere(~covered)
        at = [int(c[j]) for c, j in zip(cuts, missing[0])]
        n = int(sum(math.prod(int(cuts[d][j + 1] - cuts[d][j])
                              for d, j in enumerate(cell))
                    for cell in missing[:4096]))
        out.append(Finding(
            "coverage", "error", subject,
            f"{plan.kernel}: no block writes output {name} at {at} ({n} "
            "element(s) at least are never written)",
            {"kernel": plan.kernel, "output": name, "element": at}))


def verify_plan(plan: LaunchPlan, *, device=None,
                max_grid_points: int = MAX_GRID_POINTS) -> List[Finding]:
    """Run every static check against one plan under ``device``'s limits
    (a :class:`DeviceModel`, a CUDA device, or None for the H100's);
    findings, not exceptions."""
    subject = f"kernels/{plan.name}"
    out: List[Finding] = []
    model = _model(device)
    if not _launch_checks(plan, model, subject, out):
        return out
    if len(plan.writes) != len(plan.outputs) or len(plan.reads) != len(
            plan.operands) or (plan.masked_edges and len(
                plan.masked_edges) != len(plan.outputs)):
        out.append(Finding(
            "block-rank", "error", subject,
            f"{plan.kernel}: {len(plan.writes)} write maps for "
            f"{len(plan.outputs)} outputs, {len(plan.reads)} read maps for "
            f"{len(plan.operands)} operands", {"kernel": plan.kernel}))
        return out
    if plan.phases > 1 and not plan.cooperative:
        out.append(Finding(
            "write-race", "error", subject,
            f"{plan.kernel}: {plan.phases} phases without a grid barrier "
            "(the plan is not cooperative)", {"kernel": plan.kernel}))
    grid = tuple(int(g) for g in plan.grid)
    points, sampled = _grid_points(grid, max_grid_points)
    if sampled:
        out.append(Finding(
            "grid-sampled", "info", subject,
            f"{plan.kernel}: grid of {math.prod(grid)} blocks exceeds "
            f"{max_grid_points}; verified on a {len(points)}-block boundary "
            "sample (coverage not proved)",
            {"kernel": plan.kernel, "points": len(points)}))
    for side, maps, args in (("read", plan.reads, plan.operands),
                             ("write", plan.writes, plan.outputs)):
        for i, (fn, arg) in enumerate(zip(maps, args)):
            if side == "read" and fn == plan_lib.INDIRECT:
                continue
            try:
                blocks, phases, ranges = _collect(fn, points, grid)
            except Exception as e:     # a map's fault is a finding
                out.append(Finding(
                    "index-purity", "error", subject,
                    f"{plan.kernel}: {side} map of {arg.name} failed: "
                    f"{type(e).__name__}: {e}",
                    {"kernel": plan.kernel, "tensor": arg.name}))
                continue
            if len(blocks) and ranges.shape[1] != len(arg.shape):
                out.append(Finding(
                    "block-rank", "error", subject,
                    f"{plan.kernel}: {side} tiles of {arg.name} have rank "
                    f"{ranges.shape[1]}, the tensor {len(arg.shape)}",
                    {"kernel": plan.kernel, "tensor": arg.name}))
                continue
            masked = np.asarray(
                plan.masked_edges[i] if side == "write" and plan.masked_edges
                else (False,) * len(arg.shape), bool)
            shape = np.asarray(arg.shape, np.int64)
            lo, hi = ranges[:, :, 0], ranges[:, :, 1]
            bad = ((lo < 0) | (hi < lo)
                   | (~masked & ((hi > shape) | (lo > shape)))).any(axis=1)
            for t in np.nonzero(bad)[0][:_BOUNDS_REPORTED]:
                point = np.unravel_index(int(blocks[t]), grid)
                out.append(Finding(
                    "block-bounds", "error", subject,
                    f"{plan.kernel}: block {tuple(int(x) for x in point)} "
                    f"{side} tile {ranges[t].tolist()} of {arg.name} lies "
                    f"outside {tuple(arg.shape)} (masked edges "
                    f"{tuple(bool(m) for m in masked)})",
                    {"kernel": plan.kernel, "tensor": arg.name,
                     "tile": ranges[t].tolist()}))
            if side == "read":
                continue
            if len(phases) and (phases.min() < 0
                                or phases.max() >= max(plan.phases, 1)):
                out.append(Finding(
                    "write-race", "error", subject,
                    f"{plan.kernel}: tiles of {arg.name} in phases outside "
                    f"0..{plan.phases - 1}", {"kernel": plan.kernel}))
            lo, hi = np.minimum(lo, shape), np.minimum(hi, shape)
            keep = ~bad & (hi > lo).all(axis=1)
            _count(plan, i, arg.shape, blocks[keep], phases[keep], lo[keep],
                   hi[keep], sampled, subject, out)
    return out


def verify_kernel(name: str, **kwargs) -> List[Finding]:
    """Verify one registered kernel's example plans by name."""
    if name not in KERNEL_REGISTRY:
        return [Finding("registry", "error", f"kernels/{name}",
                        f"kernel {name!r} is not registered; known: "
                        f"{sorted(KERNEL_REGISTRY)}")]
    try:
        plans = KERNEL_REGISTRY[name]()
    except Exception as e:      # an example_plans() fault is a finding
        return [Finding("registry", "error", f"kernels/{name}",
                        f"example_plans() raised {type(e).__name__}: {e}")]
    out: List[Finding] = []
    for p in plans:
        out.extend(verify_plan(p, **kwargs))
    return out


def verify_all(names: Optional[Sequence[str]] = None,
               **kwargs) -> List[Finding]:
    """Verify every registered kernel (the CLI / session entry)."""
    out: List[Finding] = []
    for name in (names if names is not None else sorted(KERNEL_REGISTRY)):
        out.extend(verify_kernel(name, **kwargs))
    return out
