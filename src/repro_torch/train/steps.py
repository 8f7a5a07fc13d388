"""Train and eval step factories: twin of ``repro/train/steps.py``. One
generic ``make_train_step`` serves every family (the ``loss_fn`` closure
carries the model). One card has no mesh, so ``grad_specs`` has no
counterpart.

A step differentiates ``loss_fn`` with ``torch.autograd.grad`` over
detached aliases of the parameter leaves, routes the gradients through
the int8 error-feedback round trip if asked (``dist.compress``), and
takes one AdamW step (``optim.adamw``), which returns new parameter
tensors. The metrics stay on the device as 0-d tensors.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.dist import compress
from repro_torch.optim import adamw


def loss_and_grads(loss_fn: Callable, params: Any, batch: Any):
    """(loss, loss_fn's metrics, grads) of ``loss_fn(params, batch)``, the
    gradients in ``params``' tree; what a train step differentiates."""
    live = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss, aux = loss_fn(tree.unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            tree.unflatten(params, list(grads)))


def make_train_step(loss_fn: Callable, opt_cfg: adamw.AdamWConfig,
                    grad_compress=False) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics dict).

    Returns step(params, opt_state, batch) -> (params, opt_state, metrics)
    with the metrics ``loss``, the loss function's own (``ce``, ``aux``),
    ``grad_norm`` and ``lr``.

    A truthy ``grad_compress`` changes the signature to
        step(params, opt_state, compress_state, batch) ->
        (params, opt_state, compress_state, metrics):
    the int8 error-feedback residual is carried by the caller across steps
    (the train loop initializes it with ``compress.init_state`` and
    checkpoints it next to the optimizer state). ``grad_compress=True``
    uses one scale per tensor; an int (a power of two, e.g. 256) is the
    per-block scale size.
    """
    if grad_compress:
        block = None if grad_compress is True else int(grad_compress)

        def step(params, opt_state, compress_state, batch):
            loss, aux, grads = loss_and_grads(loss_fn, params, batch)
            grads, compress_state = compress.roundtrip(grads, compress_state,
                                                       block=block)
            params, opt_state, om = adamw.update(grads, opt_state, params,
                                                 opt_cfg)
            return params, opt_state, compress_state, {"loss": loss, **aux,
                                                       **om}
        return step

    def step(params, opt_state, batch):
        loss, aux, grads = loss_and_grads(loss_fn, params, batch)
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, **aux, **om}

    return step


def make_eval_step(loss_fn: Callable) -> Callable:
    @torch.no_grad()
    def step(params, batch):
        loss, aux = loss_fn(params, batch)
        return {"loss": loss, **aux}
    return step
