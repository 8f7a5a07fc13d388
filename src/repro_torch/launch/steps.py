"""Step builders for the placement trace: twin of ``repro/launch/steps.py``.

Given (arch, shape, rules), :func:`build_cell` returns the step callable,
its arguments as ``meta`` tensors (global shapes and dtypes, no storage:
the reference's ``ShapeDtypeStruct``s) and the spec tree of every
argument. The placement session (``launch/placement.py``) sanitizes the
specs against its mesh, turns the arguments into meta DTensors and runs
the step once under its collective recorder.

Ported: the dense LM family's ``train``, ``prefill`` and ``decode`` cells.
The MoE / MLA LMs (DeepSeek-V2), the GNNs and the two-tower model raise
``NotImplementedError``: their cells are ROADMAP Queue 1's next item. So
does ``grad_compress``: the int8 round trip flattens each gradient to one
row (``dist.compress``), which a DTensor sharded on two dims cannot do
without gathering it whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.configs import common as cc
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


def make_traced_train_step(loss_fn, opt_cfg: adamw.AdamWConfig):
    """``train.steps.make_train_step``'s step with each gradient settled
    on its parameter's placements (:func:`_settle`) before the update:
    step(params, opt_state, batch) -> (params, opt_state, metrics). On
    plain tensors it is that step exactly."""
    def step(params, opt_state, batch):
        loss, aux, grads = loss_and_grads(loss_fn, params, batch)
        grads = tree.map_(_settle, grads, params)
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, **aux, **om}
    return step


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what}: build_cell has the dense LM cells without gradient "
        f"compression only; the rest is ROADMAP Queue 1's next item")


def build_cell(arch: cc.ArchDef, shape: cc.ShapeSpec, rules: Rules,
               grad_compress=False,
               overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Returns a dict with:
        step: callable
        args: tuple of argument trees of meta tensors (and Python scalars)
        args_specs: tuple of spec trees (same structure)
        donate: tuple of donated argument indices
        scan_lengths: the reference's scan trip counts (recorded only: the
            port's layers are unrolled, so a trace sees every trip)

    ``overrides``: keys the model config has (``n_layers``, ``q_chunk``,
    ...) override it; keys the shape's meta carries (``batch``, ``seq``)
    override the shape. A truthy ``grad_compress`` raises (module
    docstring).
    """
    if shape.kind == "skip":
        raise ValueError(f"{arch.name}/{shape.name} is skipped: "
                         f"{shape.skip_reason}")
    overrides = dict(overrides or {})
    meta_over = {k: overrides.pop(k) for k in list(overrides)
                 if k in shape.meta}
    if arch.family != "lm":
        _not_ported(f"{arch.name} ({arch.family})")
    if grad_compress:
        _not_ported("grad_compress")
    cfg = arch.make_config(shape.name)
    cfg_over = {k: v for k, v in overrides.items() if hasattr(cfg, k)}
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    if cfg.moe or cfg.mla:
        _not_ported(f"{arch.name} (MoE / MLA)")
    meta = {**shape.meta, **meta_over}

    from repro_torch.models import transformer as tr
    params = tr.init(cfg, None, device="meta")
    pspec = tr.param_specs(cfg, rules)
    scan_lengths = [cfg.n_layers]
    if shape.kind == "train":
        ocfg = opt_config()
        opt_state = adamw.init(params, ocfg)
        step = make_traced_train_step(
            lambda p, b: tr.loss_fn(p, b, cfg, rules=rules), ocfg)
        batch, logical = cc.lm_train_inputs(meta["batch"], meta["seq"])
        return dict(step=step, args=(params, opt_state, batch),
                    args_specs=(pspec, adamw.state_specs(pspec),
                                cc.logical_to_specs(logical, rules)),
                    donate=(0, 1), scan_lengths=scan_lengths)
    if shape.kind == "prefill":
        batch, logical = cc.lm_prefill_inputs(meta["batch"], meta["seq"])
        return dict(step=lambda p, b: tr.prefill(p, b["tokens"], cfg, rules),
                    args=(params, batch),
                    args_specs=(pspec, cc.logical_to_specs(logical, rules)),
                    donate=(), scan_lengths=scan_lengths)
    if shape.kind == "decode":
        b, s = meta["batch"], meta["seq"]

        def step(params, cache, tokens, pos):
            return tr.decode_step(params, cache, tokens, pos, cfg, rules)

        return dict(step=step,
                    args=(params, tr.init_cache(cfg, b, s, device="meta"),
                          cc.sds((b, 1), torch.int32), s - 1),
                    args_specs=(pspec, tr.cache_specs(cfg, rules),
                                rules.spec("batch", None), Spec()),
                    donate=(1,), scan_lengths=scan_lengths)
    raise ValueError(f"no builder for {arch.family}/{shape.kind}")
