"""From partition to placement: block placement and mesh mapping.

Twin of ``repro/core/mapping.py``, in two parts:

1. **Block placement** (numpy, exact): an arbitrary assignment ``part`` is
   realised by permuting rows so that block ``i`` of a row-blocked array
   holds exactly the vertices mapped to bin ``i``, bins padded to a common
   block size. On one card the same permutation groups a graph's vertices
   by bin, which is what the GNN's BSR layout sees (``kernels.bsr_spmm``).

2. **Logical-mesh -> physical-topology mapping**: from a device-pair
   traffic matrix, score candidate logical->physical assignments (axis
   permutations x per-axis orders, random restarts, warm starts) with the
   paper's bottleneck objective over the machine tree. The whole candidate
   set is scored in fixed-size chunks by the batched permutation scorer
   (``objective.permutation_link_loads_batch``) on the device; a shortlist
   is re-scored through the canonical ``makespan_tree`` path, one
   ``quotient_link_loads`` launch per candidate, so "searched <= identity"
   holds exactly. Routing machines (torus presets) take the sparse
   path-table scorer. The candidate enumeration is numpy, copied over.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import objective
from repro_torch.core.topology import RoutingTopology, Topology, TreeTopology
from repro_torch.graph.graph import Graph


@dataclasses.dataclass(frozen=True)
class BlockPlacement:
    perm: np.ndarray        # [n_pad] new position of each (padded) vertex
    inverse: np.ndarray     # [n_pad] vertex at each new position
    n_pad: int              # padded length = block * k
    block: int              # rows per bin
    bin_of_row: np.ndarray  # [n_pad] bin owning each new position
    fill: np.ndarray        # [k] real vertices per bin (rest is padding)


def block_placement(part: np.ndarray, k: int) -> BlockPlacement:
    """Permutation aligning bins with contiguous equal-size blocks.

    Bin loads are generally unequal; the block size is the max bin load
    (rounded up to a multiple of 8) and smaller bins are padded with
    sentinel rows, so the padding is bounded by the partitioner's balance.
    """
    part = np.asarray(part)
    n = part.shape[0]
    counts = np.bincount(part, minlength=k)
    block = int(max(counts.max(), 1))
    block = (block + 7) // 8 * 8
    n_pad = block * k
    order = np.argsort(part, kind="stable")      # vertices grouped by bin
    inverse = np.full(n_pad, n, dtype=np.int64)  # n = sentinel (padding)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for b in range(k):
        seg = order[starts[b]:starts[b + 1]]
        inverse[b * block: b * block + seg.shape[0]] = seg
    real = inverse < n
    perm_positions = np.nonzero(real)[0]
    perm_vertices = inverse[real]
    perm_full = np.full(n + 1, n_pad - 1, dtype=np.int64)
    perm_full[perm_vertices] = perm_positions
    return BlockPlacement(
        perm=perm_full[:n], inverse=inverse, n_pad=n_pad, block=block,
        bin_of_row=np.repeat(np.arange(k), block),
        fill=counts.astype(np.int64))


def apply_placement(g: Graph, pl: BlockPlacement) -> Graph:
    """Relabel graph arrays into placement order (padding rows isolated)."""
    s = pl.perm[g.senders]
    r = pl.perm[g.receivers]
    nw = np.zeros(pl.n_pad, dtype=np.float32)
    nw[pl.perm] = g.node_weight
    order = np.argsort(s, kind="stable")
    offsets = np.zeros(pl.n_pad + 1, dtype=np.int64)
    np.add.at(offsets, s + 1, 1)
    return Graph(pl.n_pad, s[order].astype(np.int32),
                 r[order].astype(np.int32), g.edge_weight[order], nw,
                 np.cumsum(offsets))


# ---------------------------------------------------------------------------
# 2. Logical-mesh -> physical mapping
# ---------------------------------------------------------------------------

def collective_traffic_matrix(mesh_shape: Sequence[int],
                              axis_bytes: Dict[int, float]) -> np.ndarray:
    """Device-pair traffic matrix [D, D] from per-axis collective bytes.

    ``axis_bytes[a]`` = bytes each device exchanges along logical axis ``a``
    per step. The ring model charges ``bytes / (size - 1)`` to each of a
    device's ring neighbours along that axis.
    """
    shape = tuple(mesh_shape)
    d = int(np.prod(shape))
    ids = np.arange(d).reshape(shape)
    T = np.zeros((d, d), dtype=np.float64)
    for ax, nbytes in axis_bytes.items():
        size = shape[ax]
        if size <= 1 or nbytes <= 0:
            continue
        per_pair = nbytes / (size - 1)
        fwd = np.roll(ids, -1, axis=ax)
        a = ids.ravel()
        b = fwd.ravel()
        T[a, b] += per_pair
        T[b, a] += per_pair
    return T


def _gray(n: int) -> np.ndarray:
    g = np.arange(n) ^ (np.arange(n) >> 1)
    return np.argsort(g, kind="stable")


def _axis_orders(size: int) -> List[np.ndarray]:
    """Per-axis leaf orders, identity always first.

    Identity / Gray / blocked come first, as a prefix that keeps the older
    candidates' indices; then reversed and shifted ring orders: a logical
    ring is rotation/reflection symmetric, the machine tree's blocks are
    not, so shifting or reversing moves which ring links straddle block
    boundaries.
    """
    orders = [np.arange(size)]
    if size >= 4:
        orders.append(_gray(size))
        half = size // 2
        blocked = np.concatenate([np.arange(half) * 2,
                                  np.arange(half) * 2 + 1])[:size]
        orders.append(np.argsort(blocked, kind="stable"))
    if size >= 2:
        orders.append(np.arange(size)[::-1])         # reversed ring
    if size >= 3:
        orders.append(np.roll(np.arange(size), 1))   # shifted rings
    if size >= 4:
        orders.append(np.roll(np.arange(size), size // 2))
        orders.append(_gray(size)[::-1])
    seen, out = set(), []
    for o in orders:
        key = tuple(int(x) for x in o)
        if key not in seen:
            seen.add(key)
            out.append(o)
    return out


class _Edges(NamedTuple):
    """The canonical scorer's inputs on the device, built once per search:
    the traffic's symmetric arc arrays and the tree's indicator and link
    factors (only ``device_to_bin`` changes between candidates)."""
    senders: torch.Tensor         # [m] int32
    receivers: torch.Tensor       # [m] int32
    weight: torch.Tensor          # [m] f32
    subtree: torch.Tensor         # [L, k] f32
    F_l: torch.Tensor             # [L] f32


def _traffic_edges(T: np.ndarray, topo: TreeTopology,
                   device: DeviceLike = None) -> _Edges:
    """:class:`_Edges` of traffic ``T`` on ``topo``, on ``device``."""
    dev = resolve_device(device)
    iu = np.triu_indices(T.shape[0], 1)
    w = T[iu]
    nz = w > 0
    s, r = iu[0][nz], iu[1][nz]

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    return _Edges(t(np.concatenate([s, r]), torch.int32),
                  t(np.concatenate([r, s]), torch.int32),
                  t(np.concatenate([w[nz], w[nz]]).astype(np.float32),
                    torch.float32),
                  t(topo.subtree, torch.float32), t(topo.F_l, torch.float32))


def _as_batch(device_to_bin) -> np.ndarray:
    d2b = np.asarray(device_to_bin)
    return d2b[None] if d2b.ndim == 1 else d2b


def _routing_loads_batch(T: np.ndarray, topo: RoutingTopology,
                         device_to_bin: np.ndarray,
                         device: DeviceLike = None) -> np.ndarray:
    """[C, L] link loads of a batch of device->bin permutations under a
    routing oracle: ``loads[c, l] = 0.5 sum_ij T[i,j] R[d2b[i], d2b[j], l]``.

    Sparse: traffic is reduced to its unique nonzero upper-triangle pairs
    once per call, each candidate gathers only the ``[E, P]`` padded
    link/fraction tables of its permuted pairs, and the per-link reduction
    is one flat ``index_add_`` over ``row * (L+1) + link`` ids; nothing of
    size ``k^2 * L`` is built. Candidates go in chunks of
    ``2^24 / (E * P)`` to bound the ``[C, E, P]`` gather slab.
    :func:`_routing_loads_dense` is the dense oracle it is tested
    against."""
    dev = resolve_device(device)
    d2b = _as_batch(device_to_bin)
    Th = np.asarray(T, dtype=np.float64)
    iu = np.triu_indices(Th.shape[0], 1)
    pw = 0.5 * (Th[iu] + Th.T[iu])   # diag excluded: path(i, i) is empty
    nz = pw > 0
    n_cand, L = d2b.shape[0], topo.n_links
    if not nz.any() or L == 0:
        return np.zeros((n_cand, L), dtype=np.float32)
    pair_u = torch.as_tensor(iu[0][nz], dtype=torch.int64, device=dev)
    pair_v = torch.as_tensor(iu[1][nz], dtype=torch.int64, device=dev)
    pair_w = torch.as_tensor(pw[nz], dtype=torch.float32, device=dev)
    links = torch.as_tensor(topo.path_links, dtype=torch.int64, device=dev)
    fracs = torch.as_tensor(topo.path_frac, dtype=torch.float32, device=dev)
    rows_all = torch.as_tensor(d2b, dtype=torch.int64, device=dev)
    chunk = max(1, (1 << 24) // max(int(pair_u.shape[0]) * topo.max_path, 1))
    out = []
    for lo in range(0, n_cand, chunk):
        rows = rows_all[lo:lo + chunk]
        U = rows[:, pair_u]                      # [C, E] permuted pair bins
        V = rows[:, pair_v]
        lk = links[U, V]                         # [C, E, P] link ids (pad=L)
        contrib = pair_w[None, :, None] * fracs[U, V]
        c = rows.shape[0]
        seg = (torch.arange(c, device=dev)[:, None, None] * (L + 1)
               + lk).reshape(-1)
        flat = torch.zeros(c * (L + 1), dtype=torch.float32, device=dev)
        flat.index_add_(0, seg, contrib.reshape(-1))
        out.append(flat.view(c, L + 1)[:, :L])
    return torch.cat(out).cpu().numpy()


def _routing_loads_dense(T: np.ndarray, topo: RoutingTopology,
                         device_to_bin: np.ndarray,
                         device: DeviceLike = None) -> np.ndarray:
    """Reference oracle of :func:`_routing_loads_batch`: the dense
    ``[k, k, L]`` product per candidate. Builds ``topo.path_incidence``,
    so small machines only."""
    dev = resolve_device(device)
    d2b = _as_batch(device_to_bin)
    d = T.shape[0]
    R = torch.as_tensor(topo.path_incidence, device=dev)
    Tt = torch.as_tensor(np.asarray(T, dtype=np.float32), device=dev)
    rows_all = torch.as_tensor(d2b, dtype=torch.int64, device=dev)
    chunk = max(1, (1 << 24) // max(d * d * topo.n_links, 1))
    out = [0.5 * torch.einsum("ij,cijl->cl", Tt,
                              R[rows[:, :, None], rows[:, None, :]])
           for rows in torch.split(rows_all, chunk)]
    return torch.cat(out).cpu().numpy()


def _device_map_breakdown(T: np.ndarray, topo: Topology,
                          device_to_bin: np.ndarray, edges=None,
                          device: DeviceLike = None
                          ) -> objective.MakespanBreakdown:
    """The canonical breakdown of one device->bin assignment: trees through
    ``objective.makespan_tree`` (so ``quotient_link_loads`` on CUDA) over
    the traffic's arcs with no compute term; routing machines through the
    sparse scorer."""
    dev = resolve_device(device)
    d = T.shape[0]
    zeros = torch.zeros(d, dtype=torch.float32, device=dev)
    if isinstance(topo, RoutingTopology):
        loads = _routing_loads_batch(T, topo, device_to_bin, dev)[0]
        return objective.makespan_from_parts(
            zeros, torch.as_tensor(loads, device=dev),
            torch.as_tensor(topo.F_l, dtype=torch.float32, device=dev))
    e = edges if edges is not None else _traffic_edges(T, topo, dev)
    return objective.makespan_tree(
        np.asarray(device_to_bin), e.senders, e.receivers, e.weight,
        zeros, e.subtree, e.F_l, k=topo.k, device=dev)  # comp excluded


def makespan_of_device_map(T: np.ndarray, topo: Topology,
                           device_to_bin: np.ndarray,
                           device: DeviceLike = None) -> float:
    """Score a device->bin assignment: bottleneck link under traffic T.
    comp is uniform (SPMD: one shard per device), so the comm term
    decides."""
    return float(_device_map_breakdown(T, topo, device_to_bin,
                                       device=device).comm_max)


def capacity_makespan(T: np.ndarray, topo: Topology,
                      device_to_bin: np.ndarray, shard_work: float = 0.0,
                      device: DeviceLike = None) -> float:
    """Capacity-normalized makespan of a device->bin permutation:
    ``max(max_b shard_work / speed(b), comm makespan)``. Every device
    carries one equal shard, so the comp term is permutation-invariant
    (``shard_work / min(speed)`` on a heterogeneous machine, else
    ``shard_work``) and "searched <= identity" carries over from the comm
    term."""
    comm = makespan_of_device_map(T, topo, device_to_bin, device)
    speed = getattr(topo, "bin_speed", None)
    if shard_work <= 0.0:
        return comm
    comp = (float(shard_work) if speed is None
            else float(shard_work / np.asarray(speed).min()))
    return max(comp, comm)


def link_loads_of_device_map(T: np.ndarray, topo: Topology,
                             device_to_bin: np.ndarray,
                             device: DeviceLike = None) -> np.ndarray:
    """Raw (un-weighted by F_l) per-link loads of a device->bin assignment,
    in ``topo.link_nodes`` order (routing topologies: link-id order),
    clamped at 0: the load algebra cancels to small negatives in float32
    on links that carry nothing."""
    comm = _device_map_breakdown(T, topo, device_to_bin, device=device).comm
    return np.maximum(comm.cpu().numpy(), 0.0)


@dataclasses.dataclass
class MeshMapping:
    axis_perm: Tuple[int, ...]
    axis_orders: Tuple[int, ...]   # index into _axis_orders per (new) axis;
                                   # (-1, ...) marks a winner that is NOT
                                   # reconstructible from (perm, orders): a
                                   # random restart, a warm start or a
                                   # recursive-subtree improvement
    device_to_bin: np.ndarray
    bottleneck: float              # canonical makespan_tree-path score
    n_candidates: int = 0          # size of the enumerated candidate set


def enumerate_candidates(mesh_shape: Sequence[int],
                         max_axis_perms: Optional[int] = None,
                         n_random: int = 0, seed: int = 0
                         ) -> Tuple[np.ndarray, List[Tuple[Tuple[int, ...],
                                                           Tuple[int, ...]]]]:
    """The full candidate set as ONE ``[C, D]`` device->bin array.

    Logical-axis permutations x per-axis orders, by mixed-radix arithmetic:
    logical device ``d`` with coordinates ``c`` lands on leaf
    ``sum_a inv_order_a[c[perm[a]]] * stride_a``. The identity assignment
    is candidate 0, in the order of the nested loop over permutations and
    orders, so the first minimum wins ties. ``n_random`` appends seeded
    random device permutations (random restarts).

    Returns ``(device_to_bin [C, D] int64, meta)`` where ``meta[c]`` is the
    ``(axis_perm, axis_orders)`` pair; random restarts carry
    ``axis_orders = (-1,) * rank``.
    """
    shape = tuple(mesh_shape)
    r = len(shape)
    d = int(np.prod(shape))
    coords = np.empty((d, r), dtype=np.int64)       # original mixed radix
    rem = np.arange(d)
    for ax in range(r - 1, -1, -1):
        coords[:, ax] = rem % shape[ax]
        rem //= shape[ax]
    perms = list(itertools.permutations(range(r)))
    if max_axis_perms:
        perms = perms[:max_axis_perms]
    blocks: List[np.ndarray] = []
    meta: List[Tuple[Tuple[int, ...], Tuple[int, ...]]] = []
    for perm in perms:
        new_shape = tuple(shape[p] for p in perm)
        strides = np.ones(r, dtype=np.int64)
        for a in range(r - 2, -1, -1):
            strides[a] = strides[a + 1] * new_shape[a + 1]
        # inverse order maps: position of coordinate c along the new axis
        inv = [np.stack([np.argsort(o, kind="stable")
                         for o in _axis_orders(s)]) for s in new_shape]
        grid = np.stack(np.meshgrid(*[np.arange(p.shape[0]) for p in inv],
                                    indexing="ij"), axis=-1).reshape(-1, r)
        block = np.zeros((grid.shape[0], d), dtype=np.int64)
        for a in range(r):
            block += inv[a][grid[:, a]][:, coords[:, perm[a]]] * strides[a]
        blocks.append(block)
        meta.extend((perm, tuple(int(x) for x in row)) for row in grid)
    if n_random > 0:
        rng = np.random.default_rng(seed)
        blocks.append(np.stack([rng.permutation(d)
                                for _ in range(n_random)]).astype(np.int64))
        meta.extend((tuple(range(r)), (-1,) * r) for _ in range(n_random))
    return np.concatenate(blocks, axis=0), meta


@dataclasses.dataclass
class _ScorerCtx:
    """Per-(traffic, topology) inputs of the batched permutation scorer on
    the device: unique nonzero traffic pairs, the bin-pair LCA table, the
    bin- and node-level subtree indicators; built once per search."""
    pair_u: torch.Tensor
    pair_v: torch.Tensor
    pair_w: torch.Tensor
    lca: torch.Tensor
    subtree: torch.Tensor
    node_subtree: torch.Tensor
    F_l: torch.Tensor
    k: int
    n_nodes: int
    n_pairs: int


def _make_scorer_ctx(T: np.ndarray, topo: TreeTopology,
                     device: DeviceLike = None) -> _ScorerCtx:
    dev = resolve_device(device)
    iu = np.triu_indices(T.shape[0], 1)
    w = np.asarray(T, dtype=np.float64)[iu]
    nz = w > 0

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    f32 = torch.float32
    return _ScorerCtx(
        pair_u=t(iu[0][nz], torch.int64), pair_v=t(iu[1][nz], torch.int64),
        pair_w=t(w[nz].astype(np.float32), f32),
        lca=t(topo.lca_table(), torch.int64), subtree=t(topo.subtree, f32),
        node_subtree=t(topo.node_subtree_indicator(), f32),
        F_l=t(topo.F_l, f32), k=topo.k, n_nodes=topo.n_nodes,
        n_pairs=int(nz.sum()))


def score_device_maps(T: np.ndarray, topo: Topology,
                      device_to_bin: np.ndarray, chunk: int = 128,
                      _ctx: Optional[_ScorerCtx] = None,
                      device: DeviceLike = None) -> np.ndarray:
    """Bottleneck cost of every candidate device->bin permutation. [C]

    Fixed-size chunks (the tail padded with candidate 0), each chunk's link
    loads from ``objective.permutation_link_loads_batch`` (two flat
    bucketings and two products) on ``device`` (``None`` = CUDA), one copy
    to the host at the end (``_ctx``, when given, fixes the device).
    Routing topologies take the sparse path-table scorer instead of the
    tree-LCA identity."""
    if isinstance(topo, RoutingTopology):
        loads = _routing_loads_batch(T, topo, np.asarray(device_to_bin),
                                     device)
        return (loads * np.asarray(topo.F_l)[None, :]).max(
            axis=1).astype(np.float64)
    c = int(np.asarray(device_to_bin).shape[0])
    ctx = _ctx or _make_scorer_ctx(np.asarray(T, dtype=np.float64), topo,
                                   device)
    if ctx.n_pairs == 0 or topo.n_links == 0:
        return np.zeros(c, dtype=np.float64)
    d2b = torch.as_tensor(np.asarray(device_to_bin), dtype=torch.int64,
                          device=ctx.pair_w.device)
    # bound the [chunk, E] gathers for dense traffic matrices
    chunk = int(max(1, min(chunk, c, max(1, (1 << 22) // ctx.n_pairs))))
    out = []
    for lo in range(0, c, chunk):
        blk = d2b[lo:lo + chunk]
        if blk.shape[0] < chunk:
            blk = torch.cat([blk, d2b[:1].expand(chunk - blk.shape[0], -1)])
        loads = objective.permutation_link_loads_batch(
            blk, ctx.pair_u, ctx.pair_v, ctx.pair_w, ctx.lca, ctx.subtree,
            ctx.node_subtree, k=ctx.k, n_nodes=ctx.n_nodes)
        out.append((loads * ctx.F_l[None, :]).max(dim=1).values)
    return torch.cat(out)[:c].cpu().numpy().astype(np.float64)


def _refine_subtrees(T: np.ndarray, topo: TreeTopology, d2b: np.ndarray,
                     cost: float, chunk: int, ctx: _ScorerCtx
                     ) -> Tuple[np.ndarray, float]:
    """Recursive per-subtree improvement for deep trees.

    The chosen candidate fixes which device set sits under each internal
    tree node; reordering devices *within* a node's leaf block only moves
    that node's internal link loads, so each subtree greedily adopts the
    best reordering of its own block (ring orders: reversal, shifts,
    Gray), top-down. The identity reorder is always scored, so the result
    is never worse than the input.
    """
    best = np.asarray(d2b, dtype=np.int64).copy()
    root = int(np.nonzero(topo.parent < 0)[0][0])
    stack = [int(n) for n in topo.children(root)]
    while stack:
        node = stack.pop()
        stack.extend(int(n) for n in topo.children(node))
        leaves = topo.leaves_under(node)             # bin indices
        if leaves.size < 2:
            continue
        bin_to_device = np.argsort(best)
        devs = bin_to_device[leaves]                 # devices in this block
        orders = _axis_orders(int(leaves.size))
        trials = np.tile(best, (len(orders), 1))
        for ti, o in enumerate(orders):
            trials[ti, devs[o]] = leaves
        costs = score_device_maps(T, topo, trials, chunk=chunk, _ctx=ctx)
        ti = int(np.argmin(costs))
        if costs[ti] < cost:
            best, cost = trials[ti], float(costs[ti])
    return best, cost


def search_mesh_mapping(mesh_shape: Sequence[int],
                        axis_bytes: Dict[int, float],
                        topo: Optional[Topology] = None,
                        max_axis_perms: Optional[int] = None,
                        traffic: Optional[np.ndarray] = None,
                        n_random: int = 0, seed: int = 0,
                        recursive: bool = False,
                        chunk: int = 128,
                        warm_starts: Optional[Sequence[np.ndarray]] = None,
                        machine=None,
                        device: DeviceLike = None) -> MeshMapping:
    """Enumerate logical-axis permutations x per-axis orders on ``device``
    (``None`` = CUDA); return the assignment with the smallest
    bottleneck-link cost.

    Candidate 0 is the identity, so the result is never worse than it.
    ``traffic`` supplies a measured ``[D, D]`` matrix instead of the ring
    model built from ``axis_bytes``; ``n_random`` appends seeded random
    restarts; ``warm_starts`` appends prior winners (device->bin
    permutations); ``recursive=True`` runs the per-subtree reordering pass
    on the winner (trees only); ``machine`` (a ``core.machine.
    MachineSpec``) supplies the topology instead of ``topo``.

    The batched scorer picks a shortlist (its 8 best, identity and every
    warm start), which the canonical ``makespan_tree`` path re-scores: the
    batched scorer cancels O(total traffic) terms in float32 and can
    misorder near-ties, and every consumer sees costs through the
    canonical path. The first minimum of the re-scores wins.
    """
    dev = resolve_device(device)
    shape = tuple(mesh_shape)
    d = int(np.prod(shape))
    if topo is None:
        if machine is None:
            raise ValueError("search needs a topology: pass topo= or "
                             "machine=")
        topo = machine.topology()
    is_tree = isinstance(topo, TreeTopology)
    if topo.k != d:
        raise ValueError(f"topology has {topo.k} bins, mesh has {d} devices")
    if traffic is not None:
        T = np.asarray(traffic, dtype=np.float64)
        if T.shape != (d, d):
            raise ValueError(f"traffic is {T.shape}, mesh has {d} devices")
    else:
        T = collective_traffic_matrix(shape, axis_bytes)
    cands, meta = enumerate_candidates(shape, max_axis_perms,
                                       n_random=n_random, seed=seed)
    ws_lo = None
    if warm_starts is not None and len(warm_starts) > 0:
        ws = np.stack([np.asarray(w, dtype=np.int64) for w in warm_starts])
        if ws.shape[1] != d or not (np.sort(ws, axis=1)
                                    == np.arange(d)).all():
            raise ValueError("warm starts must be device->bin permutations "
                             f"of range({d})")
        ws_lo = cands.shape[0]
        cands = np.concatenate([cands, ws], axis=0)
        meta.extend((tuple(range(len(shape))), (-1,) * len(shape))
                    for _ in range(ws.shape[0]))
    ctx = _make_scorer_ctx(T, topo, dev) if is_tree else None
    costs = score_device_maps(T, topo, cands, chunk=chunk, _ctx=ctx,
                              device=dev)
    short = list(np.argsort(costs, kind="stable")[:8])
    if 0 not in short:
        short.append(0)                      # identity is always re-scored
    if ws_lo is not None:                    # ... and so is every warm start
        short.extend(j for j in range(ws_lo, cands.shape[0])
                     if j not in short)
    edges = _traffic_edges(T, topo, dev) if is_tree else None
    if is_tree:
        canon = {int(j): float(_device_map_breakdown(
            T, topo, cands[j], edges, dev).comm_max) for j in short}
    else:
        canon = {int(j): float(costs[j]) for j in short}
    i = min(canon, key=lambda j: (canon[j], j))   # ties -> first candidate
    perm, orders_idx = meta[i]
    best_d2b, best_cost = cands[i], canon[i]
    if recursive and is_tree:   # per-subtree pass is tree-only
        ref_d2b, _ = _refine_subtrees(T, topo, best_d2b, float(costs[i]),
                                      chunk, ctx)
        if not np.array_equal(ref_d2b, best_d2b):
            ref_cost = float(_device_map_breakdown(T, topo, ref_d2b, edges,
                                                   dev).comm_max)
            if ref_cost < best_cost:
                best_d2b, best_cost = ref_d2b, ref_cost
                # the assignment no longer follows from (perm, orders)
                orders_idx = (-1,) * len(shape)
    return MeshMapping(perm, orders_idx, np.asarray(best_d2b, np.int64),
                       best_cost, n_candidates=int(cands.shape[0]))


def search(mesh_shape: Sequence[int], topo: Optional[Topology],
           traffic: np.ndarray, *,
           warm_starts: Optional[Sequence[np.ndarray]] = None,
           n_random: int = 0, seed: int = 0, recursive: bool = False,
           chunk: int = 128,
           max_axis_perms: Optional[int] = None,
           machine=None, device: DeviceLike = None) -> MeshMapping:
    """Placement-facing entry of the mesh-mapping search: measured traffic
    is mandatory and ``warm_starts`` carries the prior winner(s) of a
    recompile loop, so each round's result is monotone against every
    earlier one. A keyword-only front to :func:`search_mesh_mapping`;
    ``topo=None`` with ``machine=`` derives the topology from the machine
    model."""
    return search_mesh_mapping(mesh_shape, {}, topo, traffic=traffic,
                               warm_starts=warm_starts, n_random=n_random,
                               seed=seed, recursive=recursive, chunk=chunk,
                               max_axis_perms=max_axis_perms,
                               machine=machine, device=device)


def expert_placement(traffic: np.ndarray, expert_flops: np.ndarray,
                     topo: TreeTopology, seed: int = 0, seeds: int = 1,
                     device: DeviceLike = None):
    """MoE expert placement: experts = vertices (weight = FLOPs share),
    expert-pair token traffic = edges; returns ``(expert->bin assignment,
    PartitionResult)`` from the multilevel partitioner on ``device``.
    ``seeds > 1`` runs the best-of-S refinement."""
    from repro_torch.core.partitioner import PartitionConfig, partition
    from repro_torch.graph.graph import from_edges
    e = traffic.shape[0]
    iu = np.triu_indices(e, 1)
    w = traffic[iu] + traffic.T[iu]
    nz = w > 0
    g = from_edges(e, iu[0][nz], iu[1][nz], w[nz].astype(np.float32),
                   expert_flops.astype(np.float32))
    res = partition(g, topo, PartitionConfig(seed=seed, seeds=seeds),
                    device=device)
    return res.part, res
