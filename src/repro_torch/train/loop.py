"""Fault-tolerant training loop: twin of ``run`` in
``repro/train/loop.py`` (checkpoint/restart, async saves, straggler
counting, loss tracking).

Failure model, the reference's:
  * the process can die at any step -> on restart, ``run`` resumes from the
    newest complete checkpoint (the atomic rename guarantees completeness);
  * a step can straggle -> per-step wall times feed an EWMA; steps slower
    than ``straggler_factor`` x the EWMA are counted;
  * checkpoints are pruned to a budget.

With ``LoopConfig.grad_compress`` the int8 error-feedback residual
(``dist.compress``) is part of the loop state: threaded through the step,
saved in every checkpoint, restored on resume.

Not ported yet: the fault injector (``injector=``) and ``run_supervised``,
which wait for resilience (ROADMAP Queue 1, item 6); the sparse embedding
optimizer (``embed_sparse``), which waits for recsys training (item 7).
Both raise ``NotImplementedError``. One card has no mesh, so ``run`` takes
no ``mesh`` / ``state_specs``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.dist import compress


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    fail_at_step: Optional[int] = None     # fault injection (tests)
    resume: bool = True                    # restore the newest ckpt at start
    # int8 error-feedback gradient compression: the step_fn must come from
    # make_train_step(grad_compress=...); the loop owns the residual state
    # (initialized once, threaded, checkpointed and restored). A truthy int
    # is the per-block scale size, baked into the step; the loop only
    # checks truthiness.
    grad_compress: Any = False
    # the reference's sparse embedding-table optimizer: not ported yet
    embed_sparse: Any = False


@dataclasses.dataclass
class LoopResult:
    losses: list
    steps_run: int
    resumed_from: Optional[int]
    straggler_steps: int
    seconds: float


class InjectedFailure(RuntimeError):
    pass


def run(step_fn: Callable, params: Any, opt_state: Any,
        batches: Iterator[Dict[str, Any]], cfg: LoopConfig,
        step_offset: int = 0, injector: Any = None) -> tuple:
    """Returns (params, opt_state, LoopResult)."""
    if injector is not None:
        raise NotImplementedError(
            "fault injection waits for the resilience slice (ROADMAP Queue "
            "1, item 6)")
    if cfg.embed_sparse:
        raise NotImplementedError(
            "the sparse embedding optimizer waits for the recsys-training "
            "slice (ROADMAP Queue 1, item 7)")
    saver = ckpt.AsyncSaver()
    cstate = compress.init_state(params) if cfg.grad_compress else None
    resumed_from = None
    start = step_offset

    def state_tuple():
        if cfg.grad_compress:
            return (params, opt_state, cstate)
        return (params, opt_state)

    if cfg.ckpt_dir and cfg.resume:
        latest = ckpt.latest_step(cfg.ckpt_dir, gc_tmp=True)
        if latest is not None:
            try:
                restored, _ = ckpt.restore(cfg.ckpt_dir, state_tuple(),
                                           latest)
            except ValueError:
                if not cfg.grad_compress:
                    raise
                # the checkpoint predates the residual: restore (params,
                # opt_state) and restart the residual from zeros
                restored, _ = ckpt.restore(cfg.ckpt_dir, (params, opt_state),
                                           latest)
                restored = restored + (cstate,)
            if cfg.grad_compress:
                params, opt_state, cstate = restored
            else:
                params, opt_state = restored
            start = latest
            resumed_from = latest

    losses = []
    ewma = None
    stragglers = 0
    t_begin = time.time()
    try:
        for step in range(start, cfg.total_steps):
            if cfg.fail_at_step is not None and step == cfg.fail_at_step:
                raise InjectedFailure(f"injected failure at step {step}")
            batch = next(batches)
            t0 = time.time()
            if cfg.grad_compress:
                params, opt_state, cstate, metrics = step_fn(
                    params, opt_state, cstate, batch)
            else:
                params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > cfg.straggler_factor * ewma and step > start + 3:
                stragglers += 1
            losses.append(loss)
            if cfg.ckpt_dir and (step + 1) % cfg.ckpt_every == 0:
                saver.save(cfg.ckpt_dir, step + 1, state_tuple())
                ckpt.prune(cfg.ckpt_dir, cfg.keep_ckpts)
    finally:
        saver.join()
    if cfg.ckpt_dir:
        ckpt.save(cfg.ckpt_dir, cfg.total_steps, state_tuple())
        ckpt.prune(cfg.ckpt_dir, cfg.keep_ckpts)
    return params, opt_state, LoopResult(
        losses=losses, steps_run=len(losses), resumed_from=resumed_from,
        straggler_steps=stragglers, seconds=time.time() - t_begin)
