"""Bottleneck (makespan) refinement via damped label propagation, in torch.

Twin of ``repro/core/refine.py``. Every round is a handful of products and
segment ops over the whole vertex set:

  1. Score the current assignment: per-bin loads ``comp`` and per-link
     loads ``comm`` (raw volume from the ``quotient_link_loads`` kernel,
     called with ``F_l = ones``).
  2. Price bins and links with the gradient of the annealed soft-max
     potential.
  3. Build the ``k x k`` price-distance matrix ``pi`` (two products against
     the subtree indicator).
  4. Every vertex evaluates candidate destination bins, either densely (all
     k bins, from the ``partition_gain`` kernel's connectivity rows over an
     ELL layout built once per level) or sparsely (one sampled candidate per
     vertex, O(m) via arc gathers).
  5. A damped, inflow-capped subset of positive-gain moves is applied; the
     round is judged by the true (hard-max) makespan.

``lax.scan`` becomes a Python loop over the rounds that keeps ``best_part``
and ``best_m`` on the device with ``torch.where``: nothing in the loop waits
for the device. Random numbers come from a draw source
(``core/draws.py``), so a test can feed the reference's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import objective
from repro_torch.core.draws import DrawSource, TorchDraws
from repro_torch.core.topology import TreeTopology
from repro_torch.graph.graph import Graph
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    rounds: int = 64
    damping: float = 0.5          # fraction of positive-gain moves attempted
    temp0: float = 0.25           # initial softmax temperature (relative)
    temp_min: float = 0.02
    anneal: float = 0.93          # per-round multiplicative decay
    dense_threshold: int = 200_000  # n*k above this -> sparse candidate mode
    inflow_slack: float = 0.10    # allowed inflow above current bottleneck
    seed: int = 0


class RefineStats(NamedTuple):
    makespan: torch.Tensor
    comp_max: torch.Tensor
    comm_max: torch.Tensor
    moved: torch.Tensor


class LevelArrays(NamedTuple):
    """One graph level and machine on the device, built once per level:
    int32 arc lists for the kernels, int64 senders for ``index_add_``, and
    the per-level constants of the sparse and dense rounds."""
    n: int
    k: int
    senders: torch.Tensor         # [m] int32
    receivers: torch.Tensor       # [m] int32
    senders64: torch.Tensor       # [m] int64
    edge_weight: torch.Tensor     # [m] f32
    node_weight: torch.Tensor     # [n] f32
    offsets_pad: torch.Tensor     # [n] int32 CSR row starts
    degrees: torch.Tensor         # [n] int32
    heavy_nbr: Optional[torch.Tensor]  # [n] int32 receiver of each
    #                                    vertex's heaviest arc (sparse levels)
    subtree: torch.Tensor         # [L, k] f32
    F_l: torch.Tensor             # [L] f32
    ones_l: torch.Tensor          # [L] f32 (raw comm from the kernel)
    speed: Optional[torch.Tensor]  # [k] f32 or None
    ell_idx: Optional[torch.Tensor]  # [n, D] int32 (dense levels)
    ell_w: Optional[torch.Tensor]    # [n, D] f32 (dense levels)


def level_arrays(g: Graph, topo: TreeTopology, dense: bool,
                 device: torch.device) -> LevelArrays:
    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)
    i32, f32 = torch.int32, torch.float32
    n, m = g.n_nodes, g.n_arcs
    s64 = t(g.senders, torch.int64)
    r = t(g.receivers, i32)
    w = t(g.edge_weight, f32)
    # heaviest arc per sender (sparse mode 0): exact two-pass segment
    # argmax (per-segment max weight, then the largest arc id attaining
    # it). It depends only on the graph, so it is computed once per level,
    # not once per round.
    heavy = ell_idx = ell_w = None
    if not dense and m:
        seg = objective.segment_max(w, s64, n)
        at_max = w >= seg[s64]
        arc_ids = torch.where(at_max, torch.arange(m, dtype=i32, device=device),
                              torch.full_like(r, -1))
        best_arc = objective.segment_max(arc_ids, s64, n).clamp(0, m - 1)
        heavy = r[best_arc.long()]
    if dense:
        idx, ew = kops.to_ell(n, g.senders, g.receivers, g.edge_weight)
        ell_idx, ell_w = t(idx, i32), t(ew, f32)
    F_l = t(topo.F_l, f32)
    return LevelArrays(
        n=n, k=topo.k, senders=s64.to(i32), receivers=r, senders64=s64,
        edge_weight=w, node_weight=t(g.node_weight, f32),
        offsets_pad=t(g.offsets[:-1], i32), degrees=t(g.degrees(), i32),
        heavy_nbr=heavy, subtree=t(topo.subtree, f32), F_l=F_l,
        ones_l=torch.ones_like(F_l),
        speed=None if topo.bin_speed is None else t(topo.bin_speed, f32),
        ell_idx=ell_idx, ell_w=ell_w)


def price_matrix(g_link: torch.Tensor, subtree: torch.Tensor) -> torch.Tensor:
    """pi[a, b] = sum_l g_link[l] * (S_la XOR S_lb).  [k, k], zero diagonal.

    XOR identity: S_la + S_lb - 2 S_la S_lb for 0/1 indicators.
    """
    S = subtree
    u = g_link @ S                           # [k] sum_l g_l S_la
    cross = S.T @ (g_link[:, None] * S)      # [k, k]
    return u[:, None] + u[None, :] - 2.0 * cross


def _scores(part: torch.Tensor, lv: LevelArrays, temp):
    """comp (raw), bin prices, link prices and pi of the current part."""
    comp = objective.comp_loads(part, lv.node_weight, lv.k)
    comm = kops.link_loads(part, lv.senders, lv.receivers, lv.edge_weight,
                           lv.subtree, lv.ones_l, lv.k)
    g_comp, g_link = objective.load_gradients(comp, comm, lv.F_l, temp,
                                              lv.speed)
    return comp, g_comp, price_matrix(g_link, lv.subtree)


def _apply_moves(part, cand, gain, node_weight, comp, u_gate, u_thin, k,
                 damping, inflow_slack, speed=None):
    """Damped, inflow-capped application of positive-gain moves.

    A move is attempted where ``u_gate < damping``; per destination bin,
    attempted inflow is capped so the bin does not blow past the current
    bottleneck (+slack), thinning by ``u_thin < cap ratio``. With ``speed``
    the cap runs in capacity-normalized units.
    """
    want = (gain > 0) & (cand != part) & (u_gate < damping)
    w_eff = node_weight if speed is None else node_weight / speed[cand]
    comp_n = comp if speed is None else comp / speed
    inflow = torch.zeros(k, dtype=w_eff.dtype, device=w_eff.device)
    inflow.index_add_(0, cand, torch.where(want, w_eff,
                                           torch.zeros_like(w_eff)))
    cap = torch.clamp_min(comp_n.max() * (1.0 + inflow_slack) - comp_n, 0.0)
    ratio = torch.where(inflow > 0,
                        torch.clamp_max(cap / torch.clamp_min(inflow, 1e-9),
                                        1.0),
                        torch.zeros_like(inflow))
    keep = want & (u_thin < ratio[cand])
    moved = keep.sum(dtype=torch.int32)
    return torch.where(keep, cand, part), moved


# ---------------------------------------------------------------------------
# Dense mode: every vertex scores all k destination bins.
# ---------------------------------------------------------------------------

def _dense_round(part, lv: LevelArrays, temp, u, damping, inflow_slack):
    comp, g_comp, pi = _scores(part, lv, temp)
    conn = kops.partition_gain(part, lv.ell_idx, lv.ell_w, lv.k)
    # gain[v, b] = sum_j conn[v,j] (pi[a_v, j] - pi[b, j]) + w_v (g_a - g_b)
    cur_price = (conn * pi[part]).sum(dim=1)                 # [n]
    new_price = conn @ pi.T                                  # [n, k]
    gain = (cur_price[:, None] - new_price
            + lv.node_weight[:, None] * (g_comp[part][:, None]
                                         - g_comp[None, :]))
    rows = torch.arange(lv.n, device=part.device)
    gain[rows, part] = float("-inf")
    cand = torch.argmax(gain, dim=1)            # first maximum, as jnp.argmax
    best_gain = gain[rows, cand]
    return _apply_moves(part, cand.to(part.dtype), best_gain, lv.node_weight,
                        comp, u[1], u[2], lv.k, damping, inflow_slack,
                        lv.speed)


# ---------------------------------------------------------------------------
# Sparse mode: one sampled candidate bin per vertex per round. O(m).
# ---------------------------------------------------------------------------

def _sample_candidates(part, lv: LevelArrays, g_comp, mode: int, u_cand):
    """Candidate destination bin per vertex.

    mode 0: bin of the heaviest incident arc (strongest pull)
    mode 1: bin of a uniformly random incident arc (exploration)
    mode 2: cheapest-priced bin (load escape hatch for bottleneck bins)
    """
    m = lv.receivers.shape[0]
    if m == 0:
        return part
    if mode == 0:
        cand = part[lv.heavy_nbr]
    elif mode == 1:
        rand_off = (u_cand * torch.clamp_min(lv.degrees, 1)).to(torch.int32)
        rand_arc = (lv.offsets_pad + rand_off).clamp(0, m - 1)
        cand = part[lv.receivers[rand_arc]]
    else:
        cand = torch.argmin(g_comp).to(part.dtype).expand_as(part)
    return torch.where(lv.degrees > 0, cand, part)


def _sparse_round(part, lv: LevelArrays, temp, u, mode: int, damping,
                  inflow_slack):
    comp, g_comp, pi = _scores(part, lv, temp)
    cand = _sample_candidates(part, lv, g_comp, mode, u[0])
    a_s = part[lv.senders]
    b_r = part[lv.receivers]
    c_s = cand[lv.senders]
    cur = pi[a_s, b_r]
    new = pi[c_s, b_r]
    gain = torch.zeros(lv.n, dtype=torch.float32, device=part.device)
    gain.index_add_(0, lv.senders64, lv.edge_weight * (cur - new))
    gain = gain + lv.node_weight * (g_comp[part] - g_comp[cand])
    return _apply_moves(part, cand, gain, lv.node_weight, comp, u[1], u[2],
                        lv.k, damping, inflow_slack, lv.speed)


# ---------------------------------------------------------------------------
# Trajectories
# ---------------------------------------------------------------------------

def _makespan(part, lv: LevelArrays) -> objective.MakespanBreakdown:
    return objective.makespan_tree(part, lv.senders, lv.receivers,
                                   lv.edge_weight, lv.node_weight, lv.subtree,
                                   lv.F_l, k=lv.k, speed=lv.speed,
                                   device=part.device)


def refine_core(part0: torch.Tensor, lv: LevelArrays, cfg: RefineConfig,
                dense: bool, draws: Iterator):
    """One refinement trajectory on the device. Returns (best part [n]
    int32, best makespan (0-d tensor), per-round stats of ``[rounds]``
    tensors). Nothing here synchronises with the host."""
    best_part = part = part0
    best_m = _makespan(part0, lv).makespan
    temp = np.float32(cfg.temp0)    # the reference anneals in float32
    hist = []
    for ridx in range(cfg.rounds):
        u = torch.as_tensor(next(draws), dtype=torch.float32,
                            device=part.device)
        if dense:
            part, moved = _dense_round(part, lv, temp, u, cfg.damping,
                                       cfg.inflow_slack)
        else:
            part, moved = _sparse_round(part, lv, temp, u, ridx % 3,
                                        cfg.damping, cfg.inflow_slack)
        # one breakdown per round: acceptance and stats share it
        br = _makespan(part, lv)
        better = br.makespan < best_m
        best_part = torch.where(better, part, best_part)
        best_m = torch.minimum(br.makespan, best_m)
        temp = np.maximum(np.float32(temp * np.float32(cfg.anneal)),
                          np.float32(cfg.temp_min))
        hist.append(torch.stack([br.makespan, br.comp_max, br.comm_max,
                                 moved.to(torch.float32)]))
    if hist:
        h = torch.stack(hist)
        stats = RefineStats(h[:, 0], h[:, 1], h[:, 2], h[:, 3].to(torch.int32))
    else:
        empty = torch.zeros(0, device=part.device)
        stats = RefineStats(empty, empty, empty, empty.to(torch.int32))
    return best_part, best_m, stats


def _setup(g: Graph, topo: TreeTopology, cfg: Optional[RefineConfig],
           device: DeviceLike, draws: Optional[DrawSource]):
    cfg = cfg or RefineConfig()
    dev = resolve_device(device)
    dense = g.n_nodes * topo.k <= cfg.dense_threshold
    draws = draws if draws is not None else TorchDraws(cfg.seed, dev)
    return cfg, dev, dense, draws


def refine_batch_tensors(lv: LevelArrays, parts: torch.Tensor,
                         cfg: RefineConfig, dense: bool, draws: DrawSource):
    """``refine_batch`` on device tensors: slot ``i`` draws from seed
    ``cfg.seed + i``. Returns (best parts [S, n], best makespans [S],
    stats with a leading seed axis), all on the device."""
    outs = [refine_core(parts[i], lv, cfg, dense,
                        draws.refine(cfg.seed + i, lv.n, dense))
            for i in range(parts.shape[0])]
    best_parts = torch.stack([o[0] for o in outs])
    best_ms = torch.stack([o[1] for o in outs])
    stats = RefineStats(*(torch.stack([o[2][f] for o in outs])
                          for f in range(4)))
    return best_parts, best_ms, stats


def _numpy_stats(stats: RefineStats) -> RefineStats:
    return RefineStats(*(x.cpu().numpy() for x in stats))


def refine(g: Graph, topo: TreeTopology, part: np.ndarray,
           cfg: Optional[RefineConfig] = None, *, device: DeviceLike = None,
           draws: Optional[DrawSource] = None
           ) -> Tuple[np.ndarray, float, RefineStats]:
    """Refine ``part`` on graph ``g`` over machine tree ``topo``.

    Returns (best partition, best makespan, per-round stats). Does not
    mutate ``part``. ``topo.bin_speed`` switches prices, inflow caps and
    acceptance to the capacity-normalized objective."""
    cfg, dev, dense, draws = _setup(g, topo, cfg, device, draws)
    lv = level_arrays(g, topo, dense, dev)
    p0 = torch.as_tensor(np.asarray(part), dtype=torch.int32, device=dev)
    best_part, best_m, stats = refine_core(
        p0, lv, cfg, dense, draws.refine(cfg.seed, lv.n, dense))
    return best_part.cpu().numpy(), float(best_m), _numpy_stats(stats)


def refine_batch(g: Graph, topo: TreeTopology, parts: np.ndarray,
                 cfg: Optional[RefineConfig] = None, *,
                 device: DeviceLike = None,
                 draws: Optional[DrawSource] = None
                 ) -> Tuple[np.ndarray, np.ndarray, RefineStats]:
    """Refine ``S`` initial partitions. Slot ``i`` draws from seed
    ``cfg.seed + i``, so slot 0 follows the same trajectory as
    ``refine(g, topo, parts[0], cfg)``. Returns (best parts ``[S, n]``,
    best makespans ``[S]``, stats with a leading seed axis)."""
    parts = np.asarray(parts)
    if parts.ndim != 2:
        raise ValueError(f"parts must be [S, n], got {parts.shape}")
    cfg, dev, dense, draws = _setup(g, topo, cfg, device, draws)
    lv = level_arrays(g, topo, dense, dev)
    best_parts, best_ms, stats = refine_batch_tensors(
        lv, torch.as_tensor(parts, dtype=torch.int32, device=dev), cfg,
        dense, draws)
    return (best_parts.cpu().numpy(), best_ms.cpu().numpy(),
            _numpy_stats(stats))
