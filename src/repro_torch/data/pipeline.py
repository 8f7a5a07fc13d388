"""Synthetic data pipelines, seeded and host-side.

Copies of ``lm_batches``, ``gnn_features``, the fanout sampler
(``SampledSubgraph``, ``sample_fanout``, ``minibatch_batches``),
``molecule_batches`` and ``recsys_batches`` in ``repro/data/pipeline.py``:
numpy only and exact for the same seed. The LM stream is Zipf tokens
with a copy structure so a model can reduce its loss; GNN features and
labels correlate with the graph's structure so a model can learn; recsys
item ids follow a power law so the logQ correction has something to
correct, and histories are -1 padded bags.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

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


@dataclasses.dataclass
class SampledSubgraph:
    nodes: np.ndarray        # [n_sub] original node ids (seeds first)
    senders: np.ndarray      # [e_sub] local ids (symmetric arcs)
    receivers: np.ndarray
    n_seeds: int


def sample_fanout(g: Graph, seeds: np.ndarray, fanout: Tuple[int, ...],
                  rng: np.random.Generator) -> SampledSubgraph:
    """GraphSAGE-style fixed-fanout sampling. Returns the union subgraph of
    all sampled (hop) edges, seeds first in the node order."""
    frontier = seeds
    all_nodes = [seeds]
    edges_u, edges_v = [], []
    for f in fanout:
        deg = g.offsets[frontier + 1] - g.offsets[frontier]
        # f slots per frontier node, drawn with replacement for deg > 0;
        # empty rows dropped
        nz = deg > 0
        fr = frontier[nz]
        d = deg[nz]
        # exact per-row bound: a fixed-range draw mod degree over-weights
        # low arc slots whenever 2**31 % deg != 0
        offs = rng.integers(0, d[:, None], size=(fr.shape[0], f))
        arc = g.offsets[fr][:, None] + offs
        nbrs = g.receivers[arc]                    # [n_frontier, f]
        edges_u.append(np.repeat(fr, f))
        edges_v.append(nbrs.ravel())
        frontier = np.unique(nbrs.ravel())
        all_nodes.append(frontier)
    nodes, inv = np.unique(np.concatenate(all_nodes), return_inverse=True)
    # seeds must come first: build permutation
    seed_set = np.zeros(nodes.shape[0], dtype=bool)
    seed_pos = np.searchsorted(nodes, seeds)
    seed_set[seed_pos] = True
    order = np.concatenate([np.nonzero(seed_set)[0], np.nonzero(~seed_set)[0]])
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    u = rank[np.searchsorted(nodes, np.concatenate(edges_u))]
    v = rank[np.searchsorted(nodes, np.concatenate(edges_v))]
    # symmetric arcs for message passing
    su = np.concatenate([u, v]).astype(np.int32)
    sv = np.concatenate([v, u]).astype(np.int32)
    return SampledSubgraph(nodes=nodes[np.argsort(rank)], senders=su,
                           receivers=sv, n_seeds=seeds.shape[0])


def minibatch_batches(g: Graph, feats: Dict[str, np.ndarray],
                      batch_nodes: int, fanout: Tuple[int, ...],
                      pad_nodes: int, pad_arcs: int, seed: int = 0,
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Padded sampled-subgraph batches (static shapes): ``batch_nodes``
    seeds a batch, their ``fanout`` neighbourhood's nodes and arcs padded
    to ``pad_nodes`` / ``pad_arcs``; padding arcs run from and to the sink
    node ``pad_nodes - 1``, and only the seeds carry a label."""
    rng = np.random.default_rng(seed)
    n = g.n_nodes
    while True:
        seeds = rng.choice(n, size=batch_nodes, replace=False)
        sub = sample_fanout(g, seeds, fanout, rng)
        ns = min(sub.nodes.shape[0], pad_nodes)
        ne = min(sub.senders.shape[0], pad_arcs)
        x = np.zeros((pad_nodes, feats["x"].shape[1]), np.float32)
        x[:ns] = feats["x"][sub.nodes[:ns]]
        lab = np.zeros(pad_nodes, np.int32)
        lab[:ns] = feats["labels"][sub.nodes[:ns]]
        mask = np.zeros(pad_nodes, np.float32)
        mask[:sub.n_seeds] = 1.0
        s = np.full(pad_arcs, pad_nodes - 1, np.int32)
        r = np.full(pad_arcs, pad_nodes - 1, np.int32)
        keep = (sub.senders[:ne] < ns) & (sub.receivers[:ne] < ns)
        s[:ne] = np.where(keep, sub.senders[:ne], pad_nodes - 1)
        r[:ne] = np.where(keep, sub.receivers[:ne], pad_nodes - 1)
        deg = np.zeros(pad_nodes, np.float32)
        np.add.at(deg, s, 1.0)
        batch = {"x": x, "labels": lab, "label_mask": mask,
                 "senders": s, "receivers": r,
                 "edge_weight": np.ones(pad_arcs, np.float32),
                 "degrees": deg}
        if "pos" in feats:
            pos = np.zeros((pad_nodes, 3), np.float32)
            pos[:ns] = feats["pos"][sub.nodes[:ns]]
            batch["pos"] = pos
        yield batch


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
