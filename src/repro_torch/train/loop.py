"""Fault-tolerant training loop: twin of ``repro/train/loop.py``
(checkpoint/restart, async saves, straggler counting, loss tracking, fault
injection and the restart supervisor).

Failure model, the reference's:
  * the process can die at any step -> on restart, ``run`` resumes from the
    newest complete checkpoint (the atomic rename guarantees completeness);
  * a step can straggle -> per-step wall times feed an EWMA; steps slower
    than ``straggler_factor`` x the EWMA are counted;
  * checkpoints are pruned to a budget.

With ``LoopConfig.grad_compress`` the int8 error-feedback residual
(``dist.compress``) is part of the loop state, and with
``LoopConfig.embed_sparse`` the embedding tables' rowwise-Adagrad
accumulators (``embed.training``) are: threaded through the step, saved in
every checkpoint, restored on resume.

Device failure: ``run`` consults an optional ``resilience.FaultInjector``
each step; an injected ``leaf_death`` raises
:class:`~repro_torch.resilience.faults.DeviceFailure` carrying the partial
loss trajectory. :func:`run_supervised` is the restart supervisor: it
degrades the machine model, restores the newest checkpoint and resumes on
a batch stream replayed from that step, stitching the attempts' losses
into one trajectory equal to an uninterrupted run's.

The loop never builds the mesh it runs on: ``run(..., mesh=...,
state_specs=...)`` takes it from the caller and, with both, resumes
through the elastic ``ckpt.restore_sharded``, the state placed as DTensors
on that (possibly shrunken) mesh. On a process group every rank runs the
loop: each reads the loss (a DTensor's whole value) and takes part in
every checkpoint's gathers, and rank 0 writes (``ckpt``); the caller logs
from one rank. The supervisor rebuilds the mesh over
the survivors with ``mesh_fn(n_alive)`` (default :func:`_default_mesh`, a
1-d ``data`` mesh over ``min(n_alive, world size)`` ranks of the current
process group, or no mesh without one: one card and plain tensors, where
a death shrinks only the machine model).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.dist import compress
from repro_torch.resilience.faults import (DeviceFailure, FaultInjector,
                                           plan_from)


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
    # sparse embedding-table optimizer state (embed.training): truthy holds
    # the EmbedConfig whose per-table Adagrad accumulators the loop owns
    # (initialised from params, threaded, checkpointed and restored; the
    # step_fn must come from make_embed_train_step). Mutually exclusive
    # with grad_compress (the two step signatures differ).
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


def _spec_tree_for(state: Any, state_specs: Any):
    """``True`` means fully replicated: every leaf gets a ``None`` spec
    (elastic restore onto whatever mesh survives)."""
    return None if state_specs is True else state_specs


def _scalar(t) -> float:
    """A 0-d metric as a Python float on every rank: a DTensor's whole
    value (``full_tensor()``, a collective every rank takes part in)."""
    from repro_torch.dist.sharding import _is_dtensor
    return float(t.full_tensor() if _is_dtensor(t) else t)


def run(step_fn: Callable, params: Any, opt_state: Any,
        batches: Iterator[Dict[str, Any]], cfg: LoopConfig,
        step_offset: int = 0, mesh: Any = None,
        injector: Optional[FaultInjector] = None,
        state_specs: Any = None) -> tuple:
    """Returns (params, opt_state, LoopResult). ``mesh`` (optional) is the
    caller-built ``DeviceMesh`` the run is placed on; the loop never builds
    one.

    ``injector`` fires seeded fault events by step index: a ``leaf_death``
    raises :class:`DeviceFailure` (partial ``losses`` and ``start_step``
    attached so a supervisor can stitch the trajectory), a ``straggler``
    is counted into ``straggler_steps``. ``state_specs`` (with ``mesh``)
    routes the restore through ``ckpt.restore_sharded``, so the resumed
    state is placed on the *current*, possibly shrunken, mesh; ``True``
    means fully replicated. A ``PrefetchIterator`` given as ``batches`` is
    closed on the way out."""
    if cfg.grad_compress and cfg.embed_sparse:
        raise ValueError("grad_compress and embed_sparse are mutually "
                         "exclusive (different step signatures)")
    saver = ckpt.AsyncSaver()
    cstate = compress.init_state(params) if cfg.grad_compress else None
    estate = None
    if cfg.embed_sparse:
        from repro_torch.embed import training as embed_training
        estate = embed_training.init_embed_state(params, cfg.embed_sparse)
    resumed_from = None
    start = step_offset

    def state_tuple():
        if cfg.grad_compress:
            return (params, opt_state, cstate)
        if cfg.embed_sparse:
            return (params, opt_state, estate)
        return (params, opt_state)

    def _restore(like, latest):
        if state_specs is not None and mesh is not None:
            return ckpt.restore_sharded(cfg.ckpt_dir, like,
                                        _spec_tree_for(like, state_specs),
                                        mesh, latest)[0]
        return ckpt.restore(cfg.ckpt_dir, like, latest)[0]

    try:
        if cfg.ckpt_dir and cfg.resume:
            latest = ckpt.latest_step(cfg.ckpt_dir, gc_tmp=True)
            if latest is not None:
                try:
                    restored = _restore(state_tuple(), latest)
                except ValueError:
                    if not (cfg.grad_compress or cfg.embed_sparse):
                        raise
                    # the checkpoint predates the extra loop state
                    # (residual / embed accumulators): restore (params,
                    # opt_state) and restart that state from zeros
                    restored = _restore((params, opt_state), latest)
                    restored = restored + ((cstate,) if cfg.grad_compress
                                           else (estate,))
                if cfg.grad_compress:
                    params, opt_state, cstate = restored
                elif cfg.embed_sparse:
                    params, opt_state, estate = restored
                else:
                    params, opt_state = restored
                start = latest
                resumed_from = latest

        losses = []
        ewma = None
        stragglers = 0
        t_begin = time.time()
        for step in range(start, cfg.total_steps):
            if cfg.fail_at_step is not None and step == cfg.fail_at_step:
                raise InjectedFailure(f"injected failure at step {step}")
            if injector is not None:
                for ev in injector.fire(step):
                    if ev.kind == "leaf_death":
                        err = DeviceFailure(ev)
                        err.losses = list(losses)
                        err.start_step = start
                        raise err
                    if ev.kind == "straggler":
                        stragglers += 1
            batch = next(batches)
            t0 = time.time()
            if cfg.grad_compress:
                params, opt_state, cstate, metrics = step_fn(
                    params, opt_state, cstate, batch)
            elif cfg.embed_sparse:
                params, opt_state, estate, metrics = step_fn(
                    params, opt_state, estate, batch)
            else:
                params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = _scalar(metrics["loss"])
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
        # stop a PrefetchIterator's producer thread (not a generic
        # .close(): plain generators have one too, and run_supervised
        # replays bare iterators across restart attempts)
        if getattr(batches, "is_prefetcher", False):
            batches.close()
    if cfg.ckpt_dir:
        ckpt.save(cfg.ckpt_dir, cfg.total_steps, state_tuple())
        ckpt.prune(cfg.ckpt_dir, cfg.keep_ckpts)
    return params, opt_state, LoopResult(
        losses=losses, steps_run=len(losses), resumed_from=resumed_from,
        straggler_steps=stragglers, seconds=time.time() - t_begin)


# -- restart supervisor ---------------------------------------------------

@dataclasses.dataclass
class SupervisedResult:
    """Stitched view over every attempt of a supervised run. ``losses``
    is continuous across restarts: per-attempt losses are truncated at
    the checkpoint the next attempt resumed from, so with a replayable
    batch stream the trajectory equals an uninterrupted run's exactly."""
    losses: list
    steps_run: int
    attempts: int
    recoveries: List[Dict[str, Any]]
    machine: Any                        # final (possibly degraded) spec
    final: LoopResult


def _default_mesh(n_alive: int):
    """1-d ``data`` mesh over the first ``min(n_alive, world size)`` ranks
    of the current process group (the reference clamps to the local
    devices), or None without a process group: the single-host stand-in
    for the placement session rebuilding a real mesh over the
    survivors."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    if not dist.is_available() or not dist.is_initialized():
        return None
    n = max(1, min(int(n_alive), mesh_lib.world_size()))
    return mesh_lib.make_mapped_mesh((n,), ("data",), devices=range(n))


def run_supervised(step_fn: Callable, params: Any, opt_state: Any,
                   batches_factory: Union[Callable[[int], Iterator],
                                          Iterator],
                   cfg: LoopConfig, plan: Any = None, *,
                   machine: Any = None,
                   mesh_fn: Optional[Callable] = None,
                   state_specs: Any = True, max_restarts: int = 4,
                   injector: Optional[FaultInjector] = None) -> tuple:
    """Drive :func:`run` to completion across injected device failures.

    On each :class:`DeviceFailure` the supervisor (1) degrades the machine
    spec (the dead leaf masked, so the next placement never sees a
    zero-capacity bin) and shrinks ``n_alive``, (2) rebuilds the mesh over
    the survivors (``mesh_fn(n_alive)``, default :func:`_default_mesh`),
    (3) lets ``run`` restore the newest complete checkpoint, through the
    elastic ``restore_sharded`` where there is a mesh, with the
    compression residual or the embedding accumulators where the loop
    owns them, and (4) replays the batch stream from that step
    (``batches_factory(start_step)``). The injector is shared across
    attempts, so an already-fired death is not replayed after the
    resume.

    ``batches_factory`` is ``start_step -> iterator`` (a bare iterator is
    accepted for streams that are only consumed forward: continuity then
    depends on the stream, not the supervisor). Loss stitching: the
    failed attempt's losses are kept up to the checkpoint the resume
    lands on; everything after is recomputed by the resumed attempt.

    Returns ``(params, opt_state, SupervisedResult)``.
    """
    from repro_torch.core import machine as machine_lib
    from repro_torch.launch import mesh as mesh_lib
    if injector is None:
        injector = FaultInjector(plan_from(plan))
    if machine is not None:
        machine = machine_lib.resolve(machine)
    n_alive = (machine.n_alive if machine is not None
               else mesh_lib.local_device_count())
    if mesh_fn is None:
        mesh_fn = _default_mesh
    if callable(batches_factory):
        factory = batches_factory
    else:
        stream = batches_factory

        def factory(start_step: int) -> Iterator:
            return stream

    stitched: List[float] = []
    recoveries: List[Dict[str, Any]] = []
    attempts = 0
    while True:
        attempts += 1
        start = 0
        if cfg.ckpt_dir:
            start = ckpt.latest_step(cfg.ckpt_dir, gc_tmp=True) or 0
        mesh = mesh_fn(n_alive)
        try:
            params, opt_state, res = run(
                step_fn, params, opt_state, factory(start), cfg,
                mesh=mesh, injector=injector, state_specs=state_specs)
            stitched.extend(res.losses)
            break
        except DeviceFailure as exc:
            if len(recoveries) >= max_restarts:
                raise
            latest = 0
            if cfg.ckpt_dir:
                latest = ckpt.latest_step(cfg.ckpt_dir, gc_tmp=True) or 0
            # keep only the losses the resume will NOT recompute
            keep = max(0, latest - exc.start_step)
            stitched.extend(exc.losses[:keep])
            ev = exc.event
            if machine is not None:
                machine = machine.degrade([ev])
                n_alive = machine.n_alive
            else:
                n_alive = max(1, n_alive - 1)
            recoveries.append({
                "step": int(ev.step), "device": ev.target,
                "resumed_from": int(latest), "n_alive": int(n_alive),
                "losses_kept": int(keep)})
    return params, opt_state, SupervisedResult(
        losses=stitched, steps_run=len(stitched), attempts=attempts,
        recoveries=recoveries, machine=machine, final=res)
