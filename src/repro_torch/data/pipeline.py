"""Synthetic data pipelines, seeded and host-side.

Copies of ``lm_batches``, ``gnn_features``, ``molecule_batches`` and
``recsys_batches`` in ``repro/data/pipeline.py``: numpy only and exact for
the same seed. The LM stream is Zipf tokens with a copy structure so a
model can reduce its loss; GNN features and labels correlate with the
graph's structure so a model can learn; recsys item ids follow a power law
so the logQ correction has something to correct, and histories are -1
padded bags.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.graph.generators import molecule_batch
from repro_torch.graph.graph import Graph


def lm_batches(vocab: int, batch: int, seq: int, seed: int = 0,
               zipf_a: float = 1.2) -> Iterator[Dict[str, np.ndarray]]:
    """Zipf-distributed token stream with a copy structure (next token is a
    noisy function of the current) so a model can actually reduce loss:
    ``{"tokens", "labels"}`` int32 [batch, seq], labels shifted by one."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    perm = rng.permutation(vocab)
    while True:
        toks = rng.choice(vocab, size=(batch, seq + 1), p=probs)
        # half the positions copy a permuted previous token (learnable)
        copy = rng.random((batch, seq)) < 0.5
        toks[:, 1:][copy] = perm[toks[:, :-1][copy]]
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}


def gnn_features(g: Graph, d_feat: int, n_classes: int, seed: int = 0,
                 with_pos: bool = False) -> Dict[str, np.ndarray]:
    """Node features/labels correlated with graph structure (community-ish:
    labels from a random partition smoothed one hop, features = noisy
    one-hot blocks) so GNNs can learn."""
    rng = np.random.default_rng(seed)
    n = g.n_nodes
    raw = rng.integers(0, n_classes, n)
    # one smoothing hop: adopt the majority label of neighbors
    lab = raw.copy()
    nbr_lab = raw[g.receivers]
    for c in range(n_classes):
        cnt = np.zeros(n, dtype=np.int32)
        np.add.at(cnt, g.senders, (nbr_lab == c).astype(np.int32))
        better = cnt > np.where(lab == c, -1, 0)
        lab = np.where(better, c, lab)
    feats = rng.normal(0, 1, (n, d_feat)).astype(np.float32)
    block = max(d_feat // n_classes, 1)
    for c in range(n_classes):
        sel = lab == c
        lo = (c * block) % d_feat
        feats[sel, lo:lo + block] += 2.0
    out = {"x": feats, "labels": lab.astype(np.int32),
           "label_mask": np.ones(n, np.float32),
           "degrees": g.degrees().astype(np.float32),
           "senders": g.senders, "receivers": g.receivers,
           "edge_weight": g.edge_weight}
    if with_pos:
        out["pos"] = rng.normal(0, 1, (n, 3)).astype(np.float32)
    return out


def molecule_batches(n_graphs: int, nodes_per: int, edges_per: int,
                     d_feat: int, n_classes: int, seed: int = 0
                     ) -> Iterator[Dict[str, np.ndarray]]:
    """Batches of ``n_graphs`` disjoint random molecules (block-diagonal
    adjacency) with a graph-level label: whether the molecule's degree sum
    is above the batch's median."""
    rng = np.random.default_rng(seed)
    i = 0
    while True:
        g = molecule_batch(n_graphs, nodes_per, edges_per, seed=seed + i)
        i += 1
        n = g.n_nodes
        x = rng.normal(0, 1, (n, d_feat)).astype(np.float32)
        gid = np.repeat(np.arange(n_graphs), nodes_per).astype(np.int32)
        # label = parity of a structural statistic (learnable from topology)
        deg = g.degrees().astype(np.float32)
        per_g = np.zeros(n_graphs)
        np.add.at(per_g, gid, deg)
        lab = (per_g > np.median(per_g)).astype(np.int32)
        x[:, 0] += deg * 0.5
        yield {"x": x, "pos": rng.normal(0, 1, (n, 3)).astype(np.float32),
               "senders": g.senders, "receivers": g.receivers,
               "edge_weight": g.edge_weight, "degrees": deg,
               "graph_id": gid, "labels": lab,
               "label_mask": np.ones(n_graphs, np.float32)}


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
