"""AdamW with global-norm clipping and a cosine schedule: twin of
``repro/optim/adamw.py`` over the port's parameter trees (``repro_torch.
tree``); :func:`state_specs` is the state's spec tree for a mesh trace.

``bf16_state=True`` keeps first moments in bf16; second moments stay
float32. The step count, the learning rate and the clip scale stay on the
parameters' device, so an update never waits on the host.

Weight decay follows the reference's leaf rank. The reference decays every
leaf of rank >= 2 ("norms/bias exempt"), but it stacks the layers on axis
0, so each layer's ``ln1``, ``ln2`` and QKV biases are rank 2 there and
are decayed; only ``ln_f`` is exempt. The port unrolls the layers, so it
decays by the rank a leaf has in the reference's stacked layout
(``tree.stacked_rank``) and decays exactly the leaves the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    bf16_state: bool = False


class OptState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    mu: Any
    nu: Any


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine down to ``min_lr_frac`` of ``lr``, in
    float32 as the reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(params: Any, cfg: AdamWConfig) -> OptState:
    mu_dtype = torch.bfloat16 if cfg.bf16_state else torch.float32
    mu = tree.map_(lambda p: torch.zeros_like(p, dtype=mu_dtype), params)
    nu = tree.map_(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params)
    dev = tree.leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=mu, nu=nu)


def state_specs(param_specs: Any) -> OptState:
    """The spec tree of :class:`OptState` given the params' spec tree: the
    step replicated, both moments sharded like their parameters."""
    from repro_torch.dist.sharding import Spec
    return OptState(step=Spec(), mu=param_specs, nu=param_specs)


def global_norm(grads: Any) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.to(torch.float32)))
         for x in tree.leaves(grads)])))


def update(grads: Any, state: OptState, params: Any, cfg: AdamWConfig
           ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: ``(new params, new state, {"grad_norm", "lr"})``,
    new tensors throughout (nothing is updated in place)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    lr = cosine_lr(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)

    def upd(path, g, m, v, p):
        g = g.to(torch.float32) * scale
        m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        if tree.stacked_rank(path, p) >= 2:   # the reference's decayed leaves
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p_new = p.to(torch.float32) - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new

    res = [upd(path, g, m, v, p) for (path, g), m, v, p in zip(
        tree.flatten(grads), tree.leaves(state.mu), tree.leaves(state.nu),
        tree.leaves(params))]
    new_params, new_mu, new_nu = (
        tree.unflatten(params, [r[i] for r in res]) for i in range(3))
    return new_params, OptState(step, new_mu, new_nu), {"grad_norm": gnorm,
                                                        "lr": lr}
