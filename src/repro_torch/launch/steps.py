"""Step builders for the placement trace: twin of ``repro/launch/steps.py``.

Given (arch, shape, rules), :func:`build_cell` returns the step callable,
its arguments as ``meta`` tensors (global shapes and dtypes, no storage:
the reference's ``ShapeDtypeStruct``s) and the spec tree of every
argument. The placement session (``launch/placement.py``) sanitizes the
specs against its mesh, turns the arguments into meta DTensors and runs
the step once under its collective recorder.

Every family and kind of the reference's grid: the LMs' ``train``,
``prefill`` and ``decode`` (dense GQA and MoE + MLA, the MoE on its
default route or, with ``ep_shard_map``, the expert-parallel one), the
GNNs' ``train`` (EquiformerV2 with positions) and the two-tower model's
``train``, ``score`` and ``retrieve``. A train cell with
``grad_compress`` takes the int8 error-feedback residual as its third
argument, placed like the parameters (the reference's
``_with_compress_state``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

import math

from repro_torch import tree
from repro_torch.configs import common as cc
from repro_torch.dist import compress
from repro_torch.dist.sharding import (Rules, Spec, gnn_rules, lm_rules,
                                       recsys_rules)
from repro_torch.optim import adamw
from repro_torch.train.steps import loss_and_grads


def rules_for(family: str, mesh_axes, profile: str = "2d") -> Rules:
    if family == "lm":
        return lm_rules(mesh_axes, profile=profile)
    if family == "gnn":
        return gnn_rules(mesh_axes)
    if family == "recsys":
        return recsys_rules(mesh_axes)
    raise ValueError(family)


def opt_config(total_steps: int = 1000) -> adamw.AdamWConfig:
    return adamw.AdamWConfig(total_steps=total_steps)


def _settle(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's dtype, redistributed once to its
    parameter's placements. Backward leaves a DTensor gradient partial over
    the mesh dims its products contracted; left so, AdamW's float32 upcast
    and each use after it (the global norm's square, the update's moments)
    would reduce it again, in float32. XLA reduces the bf16 gradient once,
    to the parameter's sharding; so does this. A plain tensor is returned
    as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(g, DTensor):
        return g
    return g.to(p.dtype).redistribute(p.device_mesh, p.placements)


def make_traced_train_step(loss_fn, opt_cfg: adamw.AdamWConfig,
                           grad_compress=False):
    """``train.steps.make_train_step``'s step with each gradient settled
    on its parameter's placements (:func:`_settle`) before the update:
    step(params, opt_state, batch) -> (params, opt_state, metrics), or
    with a truthy ``grad_compress`` step(params, opt_state, compress_state,
    batch) -> (params, opt_state, compress_state, metrics), the settled
    gradients through ``dist.compress.roundtrip`` first (``True``: one
    scale a tensor; an int: the block size). It is the trainer's step on a
    mesh, its arguments real DTensors, and the placement trace's, on meta
    DTensors. The step runs under ``implicit_replication``: plain operands
    (the rope tables, the step count, the learning rate) meet DTensors as
    replicated, as they do in the trace (``placement.trace_step``). On
    plain tensors it is that step exactly."""
    from torch.distributed.tensor.experimental import implicit_replication

    def grads_of(params, batch):
        loss, aux, grads = loss_and_grads(loss_fn, params, batch)
        return loss, aux, tree.map_(_settle, grads, params)

    if grad_compress:
        block = None if grad_compress is True else int(grad_compress)

        def step(params, opt_state, compress_state, batch):
            with implicit_replication():
                loss, aux, grads = grads_of(params, batch)
                grads, compress_state = compress.roundtrip(
                    grads, compress_state, block=block)
                params, opt_state, om = adamw.update(grads, opt_state,
                                                     params, opt_cfg)
            return params, opt_state, compress_state, {"loss": loss, **aux,
                                                       **om}
        return step

    def step(params, opt_state, batch):
        with implicit_replication():
            loss, aux, grads = grads_of(params, batch)
            params, opt_state, om = adamw.update(grads, opt_state, params,
                                                 opt_cfg)
        return params, opt_state, {"loss": loss, **aux, **om}
    return step


def _train_cell(params, pspec, loss_fn, batch, bspec, grad_compress,
                scan_lengths) -> Dict[str, Any]:
    """A train cell: (params, opt_state[, compress_state], batch), the
    residual as the reference's ``_with_compress_state`` inserts it
    (float32, shaped and placed like the parameters)."""
    ocfg = opt_config()
    step = make_traced_train_step(loss_fn, ocfg, grad_compress)
    args = (params, adamw.init(params, ocfg), batch)
    specs = (pspec, adamw.state_specs(pspec), bspec)
    donate = (0, 1)
    if grad_compress:
        args = args[:2] + (compress.init_state(params),) + args[2:]
        specs = specs[:2] + (pspec,) + specs[2:]
        donate = (0, 1, 2)
    return dict(step=step, args=args, args_specs=specs, donate=donate,
                scan_lengths=scan_lengths)


def build_cell(arch: cc.ArchDef, shape: cc.ShapeSpec, rules: Rules,
               grad_compress=False,
               overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Returns a dict with:
        step: callable
        args: tuple of argument trees of meta tensors (and Python scalars)
        args_specs: tuple of spec trees (same structure)
        donate: tuple of donated argument indices
        scan_lengths: the reference's scan trip counts (recorded only: the
            port's layers and arc blocks are unrolled, so a trace sees
            every trip)

    ``overrides``: keys the model config has (``n_layers``, ``q_chunk``,
    ``edge_chunk``, ...) override it; keys the shape's meta carries
    (``batch``, ``seq``, ``arcs``, ...) override the shape. A truthy
    ``grad_compress`` makes a train cell's step take the compression
    residual as its third argument (``make_traced_train_step``).
    """
    if shape.kind == "skip":
        raise ValueError(f"{arch.name}/{shape.name} is skipped: "
                         f"{shape.skip_reason}")
    overrides = dict(overrides or {})
    meta_over = {k: overrides.pop(k) for k in list(overrides)
                 if k in shape.meta}
    cfg = arch.make_config(shape.name)
    cfg_over = {k: v for k, v in overrides.items() if hasattr(cfg, k)}
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    meta = {**shape.meta, **meta_over}
    if arch.family == "lm":
        return _lm_cell(cfg, shape.kind, meta, rules, grad_compress)
    if arch.family == "gnn" and shape.kind == "train":
        return _gnn_cell(arch, cfg, meta, rules, grad_compress)
    if arch.family == "recsys":
        return _recsys_cell(cfg, shape.kind, meta, rules, grad_compress)
    raise ValueError(f"no builder for {arch.family}/{shape.kind}")


def _lm_cell(cfg, kind: str, meta, rules: Rules, grad_compress):
    from repro_torch.models import transformer as tr
    params = tr.init(cfg, None, device="meta")
    pspec = tr.param_specs(cfg, rules)
    scan_lengths = [cfg.n_layers]
    if kind == "train":
        batch, logical = cc.lm_train_inputs(meta["batch"], meta["seq"])
        return _train_cell(
            params, pspec, lambda p, b: tr.loss_fn(p, b, cfg, rules=rules),
            batch, cc.logical_to_specs(logical, rules), grad_compress,
            scan_lengths)
    if kind == "prefill":
        batch, logical = cc.lm_prefill_inputs(meta["batch"], meta["seq"])
        return dict(step=lambda p, b: tr.prefill(p, b["tokens"], cfg, rules),
                    args=(params, batch),
                    args_specs=(pspec, cc.logical_to_specs(logical, rules)),
                    donate=(), scan_lengths=scan_lengths)
    if kind == "decode":
        b, s = meta["batch"], meta["seq"]

        def step(params, cache, tokens, pos):
            return tr.decode_step(params, cache, tokens, pos, cfg, rules)

        return dict(step=step,
                    args=(params, tr.init_cache(cfg, b, s, device="meta"),
                          cc.sds((b, 1), torch.int32), s - 1),
                    args_specs=(pspec, tr.cache_specs(cfg, rules),
                                rules.spec("batch", None), Spec()),
                    donate=(1,), scan_lengths=scan_lengths)
    raise ValueError(f"no builder for lm/{kind}")


def _gnn_cell(arch: cc.ArchDef, cfg, meta, rules: Rules, grad_compress):
    is_eq = arch.name == "equiformer-v2"
    if is_eq:
        from repro_torch.models import equiformer as mdl
    else:
        from repro_torch.models import gnn as mdl
    graph_level = bool(meta.get("graph_level"))
    batch, logical = cc.gnn_train_inputs(
        meta["n"], meta["arcs"], meta["d_feat"],
        meta["graphs"] if graph_level else meta["n"], with_pos=is_eq,
        graph_level=graph_level)
    chunk = getattr(cfg, "edge_chunk", 0)
    scan_lengths = [cfg.n_layers]
    if chunk:
        scan_lengths.append((meta["arcs"] + chunk - 1) // chunk)
    return _train_cell(
        mdl.init(cfg, None, device="meta"), mdl.param_specs(cfg, rules),
        lambda p, b: mdl.loss_fn(p, b, cfg, rules=rules), batch,
        cc.logical_to_specs(logical, rules), grad_compress, scan_lengths)


def _recsys_cell(cfg, kind: str, meta, rules: Rules, grad_compress):
    from repro_torch.launch.mesh import world_size
    from repro_torch.models import recsys as rs
    # the reference pads the tables to lcm(its device count, 8) rows
    params = rs.init(cfg, None, device="meta",
                     row_multiple=math.lcm(world_size(), 8))
    pspec = rs.param_specs(cfg, rules)
    if kind == "train":
        batch, logical = cc.recsys_train_inputs(meta["batch"], cfg.hist_len,
                                                cfg.d_dense)
        return _train_cell(
            params, pspec, lambda p, b: rs.loss_fn(p, b, cfg, rules=rules),
            batch, cc.logical_to_specs(logical, rules), grad_compress, [])
    if kind == "score":
        batch, logical = cc.recsys_train_inputs(meta["batch"], cfg.hist_len,
                                                cfg.d_dense)
        step = lambda p, b: rs.score(p, b, cfg)  # noqa: E731
    elif kind == "retrieve":
        batch, logical = cc.recsys_retrieve_inputs(
            cfg.hist_len, cfg.d_dense, meta["n_cand"], cfg.embed_dim)
        step = lambda p, b: rs.retrieve(p, b, cfg, rules=rules)  # noqa: E731
    else:
        raise ValueError(f"no builder for recsys/{kind}")
    return dict(step=step, args=(params, batch),
                args_specs=(pspec, cc.logical_to_specs(logical, rules)),
                donate=(), scan_lengths=[])
