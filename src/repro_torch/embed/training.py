"""Sparse-update train step for embedding-table params: twin of
``repro/embed/training.py``.

``make_embed_train_step`` splits the param tree: dense params (the
towers) keep AdamW exactly as ``train/steps.py:make_train_step`` does; the
named embedding tables take the rowwise-Adagrad *masked* update
(``hot_cache.masked_row_update``): touched rows step, untouched rows are
selected bitwise unchanged. The per-table accumulator is the
``embed_state`` the train loop threads through every step and
checkpoints next to the optimizer state (as the int8 compression
residual).

One step of this path equals one step of the dense path (``sparse=False``:
plain ``dense_row_update`` on the full table) on the same batch, bit for
bit: sparse is an optimisation, never a change of numerics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.embed.hot_cache import dense_row_update, masked_row_update
from repro_torch.optim import adamw
from repro_torch.train.steps import loss_and_grads


@dataclasses.dataclass(frozen=True)
class EmbedConfig:
    """Which params are tables and how their rows step."""
    tables: Tuple[str, ...] = ("item_table", "cat_table")
    lr: float = 0.05
    eps: float = 1e-8
    sparse: bool = True      # masked touched-rows update vs dense

    def split(self, tree: Dict[str, Any]):
        dense = {k: v for k, v in tree.items() if k not in self.tables}
        tables = {k: tree[k] for k in self.tables if k in tree}
        return dense, tables


def init_embed_state(params: Dict[str, Any],
                     cfg: EmbedConfig) -> Dict[str, torch.Tensor]:
    """One float32 Adagrad accumulator scalar per table row."""
    return {name: torch.zeros(params[name].shape[0], dtype=torch.float32,
                              device=params[name].device)
            for name in cfg.tables if name in params}


def init_dense_opt(params: Dict[str, Any], cfg: EmbedConfig,
                   ocfg: adamw.AdamWConfig) -> adamw.OptState:
    """AdamW state over the NON-table subtree only (tables carry the
    rowwise accumulator instead)."""
    dense, _ = cfg.split(params)
    return adamw.init(dense, ocfg)


def make_embed_train_step(loss_fn: Callable, ocfg: adamw.AdamWConfig,
                          ecfg: EmbedConfig) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics).

    Returns ``step(params, opt_state, embed_state, batch) ->
    (params, opt_state, embed_state, metrics)``, the signature the train
    loop threads when ``LoopConfig.embed_sparse`` is set. ``opt_state``
    must come from :func:`init_dense_opt`.
    """
    row_update = masked_row_update if ecfg.sparse else dense_row_update

    def step(params, opt_state, embed_state, batch):
        loss, aux, grads = loss_and_grads(loss_fn, params, batch)
        dense_g, table_g = ecfg.split(grads)
        dense_p, _ = ecfg.split(params)
        new_dense, opt_state, om = adamw.update(dense_g, opt_state,
                                                dense_p, ocfg)
        new_params = dict(params)
        new_params.update(new_dense)
        new_state = dict(embed_state)
        for name, g in table_g.items():
            new_params[name], new_state[name] = row_update(
                params[name], embed_state[name], g,
                lr=ecfg.lr, eps=ecfg.eps)
        return new_params, opt_state, new_state, {"loss": loss, **aux,
                                                  **om}

    return step
