"""Synthetic recsys batches, seeded and host-side.

Copy of ``recsys_batches`` in ``repro/data/pipeline.py``: numpy only and
exact for the same seed. Item ids follow a power law so the logQ correction
has something to correct; histories are -1 padded bags.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def item_categories(n_items: int, n_cats: int,
                    seed: int = 0) -> np.ndarray:
    """The item -> category map ``recsys_batches(..., seed)`` draws first
    (its batches' ``item_cat``), for scoring the whole catalogue."""
    return np.random.default_rng(seed).integers(
        0, n_cats, n_items).astype(np.int32)


def recsys_batches(n_items: int, n_cats: int, batch: int, hist_len: int,
                   d_dense: int, seed: int = 0, zipf_a: float = 1.1
                   ) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    log_q = np.log(probs).astype(np.float32)
    cat_of = rng.integers(0, n_cats, n_items).astype(np.int32)
    while True:
        item = rng.choice(n_items, size=batch, p=probs).astype(np.int32)
        # history correlated with the positive item's category
        hist = rng.choice(n_items, size=(batch, hist_len), p=probs)
        drop = rng.random((batch, hist_len)) < 0.2
        hist = np.where(drop, -1, hist).astype(np.int32)
        dense = rng.normal(0, 1, (batch, d_dense)).astype(np.float32)
        yield {"user_hist": hist, "user_dense": dense, "item_id": item,
               "item_cat": cat_of[item], "log_q": log_q[item]}
