"""Multilevel coarsening: vectorized heavy-edge matching + contraction.

Twin of ``repro/core/coarsen.py``, with two interchangeable front ends:

  * the host-numpy path (``coarsen``) — lexsort / ``np.add.at`` /
    ``np.unique``; a copy of the reference, exact for the same seed;
  * the device path (``coarsen_device``) — the same heavy-edge matching and
    contraction as torch segment ops on the device (cumsum rank/relabel,
    stable-argsort edge dedup), each matching round's mask, jittered keys
    and two-pass segment argmax fused in the ``match_round`` CUDA kernel.
    The reference pads arrays to powers of two to bound XLA recompiles;
    PyTorch runs eagerly, so the port does not pad (padded arcs carried
    key -1 and never won). Per level, the two counts (coarse nodes and
    edges) sync back together, then the coarse graph is copied to the
    host once to form the level's ``Graph``; the next step starts from
    the device copy.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.draws import DrawSource, TorchDraws
from repro_torch.core.objective import segment_max
from repro_torch.graph.graph import Graph, from_edges
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class Level:
    graph: Graph
    fine_to_coarse: np.ndarray  # [n_fine] mapping into this level's graph


def heaviest_neighbor(g: Graph, rng: np.random.Generator,
                      eligible: np.ndarray) -> np.ndarray:
    """prop[v] = eligible neighbor with max (jittered) edge weight, else v."""
    w = g.edge_weight * (1.0 + 0.01 * rng.random(g.n_arcs).astype(np.float32))
    w = np.where(eligible[g.receivers] & eligible[g.senders], w, -1.0)
    # last-per-sender after sorting by (sender, w): CSR is sender-sorted, so
    # argsort w within rows via lexsort on (w, sender)
    order = np.lexsort((w, g.senders))
    s_sorted = g.senders[order]
    last = np.nonzero(np.diff(np.append(s_sorted, -1)) != 0)[0]
    prop = np.arange(g.n_nodes, dtype=np.int64)
    best_arc = order[last]
    ok = w[best_arc] > 0
    prop[s_sorted[last][ok]] = g.receivers[best_arc][ok]
    return prop


def match_round(g: Graph, rng: np.random.Generator,
                matched: np.ndarray) -> np.ndarray:
    """One round of mutual-proposal matching. Returns partner[v] (= v if
    unmatched). Mutual handshakes only -> valid matching."""
    prop = heaviest_neighbor(g, rng, ~matched)
    partner = np.arange(g.n_nodes, dtype=np.int64)
    mutual = (prop[prop] == np.arange(g.n_nodes)) & (prop != np.arange(g.n_nodes))
    partner[mutual] = prop[mutual]
    return partner


def contract(g: Graph, partner: np.ndarray) -> Tuple[Graph, np.ndarray]:
    """Contract matched pairs. Returns (coarse graph, fine->coarse map)."""
    rep = np.minimum(np.arange(g.n_nodes, dtype=np.int64), partner)
    uniq, coarse_id = np.unique(rep, return_inverse=True)
    nc = uniq.shape[0]
    nw = np.zeros(nc, dtype=np.float32)
    np.add.at(nw, coarse_id, g.node_weight)
    cu = coarse_id[g.senders]
    cv = coarse_id[g.receivers]
    keep = cu < cv  # one arc per undirected fine edge; drops intra-cluster
    cg = from_edges(nc, cu[keep], cv[keep], g.edge_weight[keep], nw, dedup=True)
    return cg, coarse_id


def coarsen(g: Graph, k: int, seed: int = 0, max_levels: int = 40,
            coarse_factor: int = 24, min_reduction: float = 0.05) -> List[Level]:
    """Coarsening chain, finest first. ``levels[0].graph is g``; each level's
    ``fine_to_coarse`` maps into the NEXT level's graph (standard multilevel
    bookkeeping). Stops near ``coarse_factor * k`` vertices or when matching
    stalls (reduction < min_reduction)."""
    rng = np.random.default_rng(seed)
    levels = [Level(graph=g, fine_to_coarse=None)]  # type: ignore[arg-type]
    cur = g
    for _ in range(max_levels):
        if cur.n_nodes <= coarse_factor * k or cur.n_arcs == 0:
            break
        matched = np.zeros(cur.n_nodes, dtype=bool)
        partner = np.arange(cur.n_nodes, dtype=np.int64)
        for _round in range(3):
            p = match_round(cur, rng, matched)
            new = (p != np.arange(cur.n_nodes)) & ~matched
            partner[new] = p[new]
            matched |= new | matched[p]
            matched[p[new]] = True
        nxt, mapping = contract(cur, partner)
        if nxt.n_nodes >= cur.n_nodes * (1.0 - min_reduction):
            break
        levels[-1] = Level(graph=levels[-1].graph, fine_to_coarse=mapping)
        levels.append(Level(graph=nxt, fine_to_coarse=None))  # type: ignore[arg-type]
        cur = nxt
    return levels


# ---------------------------------------------------------------------------
# Device path: torch segment-op matching + contraction
# ---------------------------------------------------------------------------

class CoarseStep(NamedTuple):
    """One device coarsening level. ``coarse_id`` [n] relabels fine
    vertices; ``nw_c`` [n] coarse node weights (first ``nc`` valid);
    ``cu_e``/``cv_e``/``w_e`` [m] the deduplicated undirected coarse edges
    (first ``m_new`` valid). ``nc``/``m_new`` are 0-d device tensors."""
    coarse_id: torch.Tensor
    nc: torch.Tensor
    nw_c: torch.Tensor
    cu_e: torch.Tensor
    cv_e: torch.Tensor
    w_e: torch.Tensor
    m_new: torch.Tensor


def coarsen_step(s: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                 nw: torch.Tensor, draws: DrawSource, level: int,
                 rounds: int = 3) -> CoarseStep:
    """One level of device coarsening over the arc list ``s``/``r``/``w``
    (int32, int32, float32 [m], CSR-sorted) and node weights ``nw`` [n]."""
    dev = w.device
    n, m = nw.shape[0], w.shape[0]
    i32 = torch.int32
    s64, r64 = s.long(), r.long()            # int64 indices, once per level
    iota_n = torch.arange(n, dtype=i32, device=dev)
    matched = torch.zeros(n, dtype=torch.bool, device=dev)
    partner = iota_n

    for rnd in range(rounds):
        u = torch.as_tensor(draws.match(level, rnd, m), dtype=torch.float32,
                            device=dev)
        # per sender, the live arc of the largest jittered key (the largest
        # arc id among equal keys), < 0 where none: the vertex proposes
        # itself
        best_arc = kops.match_round(s, r, w, u, matched)
        prop = torch.where(best_arc >= 0, r[best_arc.clamp_min(0).long()],
                           iota_n)
        mutual = (prop[prop.long()] == iota_n) & (prop != iota_n)
        new = mutual & ~matched
        partner = torch.where(new, prop, partner)
        matched = matched | new

    # contraction: rep = min(v, partner), leaders ranked by prefix sum
    rep = torch.minimum(iota_n, partner).long()
    is_leader = rep == iota_n
    rank = torch.cumsum(is_leader, dim=0, dtype=i32) - 1
    coarse_id = rank[rep]
    nc = is_leader.sum()
    nw_c = torch.zeros(n, dtype=nw.dtype, device=dev)
    nw_c.index_add_(0, coarse_id, nw)

    # dedup: keep one direction per undirected coarse edge, sort by
    # (cu, cv) via two stable passes, sum run weights
    cu = coarse_id[s64]
    cv = coarse_id[r64]
    keep = cu < cv
    junk = torch.full_like(cu, n)                # junk runs sort last
    cu_k = torch.where(keep, cu, junk)
    cv_k = torch.where(keep, cv, junk)
    w_k = torch.where(keep, w, torch.zeros_like(w))
    ord1 = torch.argsort(cv_k, stable=True)
    ord2 = torch.argsort(cu_k[ord1], stable=True)
    order = ord1[ord2]
    cu_s, cv_s, w_s = cu_k[order], cv_k[order], w_k[order]
    kept_s = cu_s < n
    first = torch.ones(1, dtype=torch.bool, device=dev)
    head = kept_s & torch.cat([first, (cu_s[1:] != cu_s[:-1])
                               | (cv_s[1:] != cv_s[:-1])])
    eid = (torch.cumsum(head, dim=0) - 1).clamp_min(0)   # int64
    w_e = torch.zeros(m, dtype=w.dtype, device=dev)
    w_e.index_add_(0, eid, w_s)
    cu_e = segment_max(torch.where(kept_s, cu_s, torch.full_like(cu_s, -1)),
                       eid, m)
    cv_e = segment_max(torch.where(kept_s, cv_s, torch.full_like(cv_s, -1)),
                       eid, m)
    return CoarseStep(coarse_id, nc, nw_c, cu_e, cv_e, w_e, head.sum())


def _csr_on_device(nc: int, cu: torch.Tensor, cv: torch.Tensor,
                   w: torch.Tensor, nw: torch.Tensor):
    """``from_edges(..., dedup=False)`` of an undirected edge list, on the
    device: both arc directions, stably sorted by sender (the same order
    numpy's stable argsort gives). Returns the device arc arrays and the
    host ``Graph``."""
    s = torch.cat([cu, cv])
    r = torch.cat([cv, cu])
    order = torch.argsort(s, stable=True)
    s, r, w2 = s[order], r[order], torch.cat([w, w])[order]
    s_h = s.cpu().numpy().astype(np.int32)
    offsets = np.zeros(nc + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(np.bincount(s_h, minlength=nc))
    graph = Graph(n_nodes=nc, senders=s_h,
                  receivers=r.cpu().numpy().astype(np.int32),
                  edge_weight=w2.cpu().numpy().astype(np.float32),
                  node_weight=nw.cpu().numpy().astype(np.float32),
                  offsets=offsets)
    return s, r, w2, graph


def coarsen_device(g: Graph, k: int, seed: int = 0, max_levels: int = 40,
                   coarse_factor: int = 24, min_reduction: float = 0.05, *,
                   device: DeviceLike = None,
                   draws: Optional[DrawSource] = None) -> List[Level]:
    """Device-resident coarsening chain — same contract and stop criteria
    as :func:`coarsen`, with matching and contraction as torch segment ops
    on ``device`` (``None`` = CUDA). Levels are materialized as host
    ``Graph`` objects, as in the reference; all per-arc work happens on the
    device. Matching jitter comes from ``draws`` (default: a
    ``torch.Generator`` seeded with ``seed``)."""
    dev = resolve_device(device)
    draws = draws if draws is not None else TorchDraws(seed, dev)
    levels = [Level(graph=g, fine_to_coarse=None)]  # type: ignore[arg-type]
    cur = g
    s = torch.as_tensor(g.senders, dtype=torch.int32, device=dev)
    r = torch.as_tensor(g.receivers, dtype=torch.int32, device=dev)
    w = torch.as_tensor(g.edge_weight, dtype=torch.float32, device=dev)
    nw = torch.as_tensor(g.node_weight, dtype=torch.float32, device=dev)
    for lvl in range(max_levels):
        if cur.n_nodes <= coarse_factor * k or cur.n_arcs == 0:
            break
        st = coarsen_step(s, r, w, nw, draws, lvl)
        nc, m_new = torch.stack([st.nc, st.m_new]).tolist()
        if nc >= cur.n_nodes * (1.0 - min_reduction):
            break
        nw = st.nw_c[:nc]
        s, r, w, nxt = _csr_on_device(nc, st.cu_e[:m_new], st.cv_e[:m_new],
                                      st.w_e[:m_new], nw)
        mapping = st.coarse_id.cpu().numpy().astype(np.int64)
        levels[-1] = Level(graph=levels[-1].graph, fine_to_coarse=mapping)
        levels.append(Level(graph=nxt, fine_to_coarse=None))  # type: ignore[arg-type]
        cur = nxt
    return levels
