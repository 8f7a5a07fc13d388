"""The paper's objective in PyTorch.

Twin of ``repro/core/objective.py``. Everything is written over the
quotient matrix ``W`` (inter-bin arc weights) and the subtree indicator
``S``:

    comm(l) = sum_ij W_ij * (S_li XOR S_lj)
            = 0.5 * ((S @ r)_l + (S @ c)_l - 2 * diag(S @ W @ S^T)_l)

(r/c = row/column sums; the 0.5 counts each undirected edge once).
``makespan_tree`` takes its comm from the ``quotient_link_loads`` kernel
(``kernels.ops.link_loads``) called with ``F_l = ones``, so the breakdown
keeps the raw per-link volume that ``PartitionResult.comm`` and ``verify()``
need. ``makespan_routing`` scores a routing oracle through the dense
``[k, k, L]`` path incidence; ``permutation_link_loads[_batch]`` and
``makespan_tree_batch`` are the mapping search's candidate scorers.
``soft_cost`` / ``load_gradients`` are the temperature-annealed
potential the refinement prices moves with; ``total_cut`` and
``comm_volumes`` are the classic metrics ``baselines.score_all`` reports.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
# the plain pieces of the quotient_link_loads kernel are the objective's own
from repro_torch.kernels.quotient_link_loads import (  # noqa: F401
    link_loads_tree, quotient_matrix)


class MakespanBreakdown(NamedTuple):
    makespan: torch.Tensor      # scalar
    comp: torch.Tensor          # [k] per-bin compute loads (speed-normalized
    #                             when the machine is heterogeneous)
    comm: torch.Tensor          # [L] per-link communication volumes
    comp_max: torch.Tensor
    comm_max: torch.Tensor      # max_l F_l * comm(l)


def comp_loads(part: torch.Tensor, node_weight: torch.Tensor, k: int,
               speed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """comp(b): sum of vertex weights mapped to each bin. [k]; with
    ``speed`` the capacity-normalized load ``comp(b) / speed(b)``."""
    comp = torch.zeros(k, dtype=node_weight.dtype, device=node_weight.device)
    comp.index_add_(0, part, node_weight)
    if speed is not None:
        comp = comp / speed
    return comp


def makespan_from_parts(comp: torch.Tensor, comm: torch.Tensor,
                        F_l: torch.Tensor,
                        router_mask: Optional[torch.Tensor] = None
                        ) -> MakespanBreakdown:
    comp_eff = comp
    if router_mask is not None:
        comp_eff = torch.where(router_mask, torch.zeros_like(comp), comp)
    comp_max = comp_eff.max()
    comm_max = ((F_l * comm).max() if comm.shape[0]
                else torch.zeros((), dtype=comp.dtype, device=comp.device))
    return MakespanBreakdown(torch.maximum(comp_max, comm_max), comp, comm,
                             comp_max, comm_max)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max`` twin: per-segment max, with EMPTY segments
    holding the identity (-inf for floats, the int minimum for ints), as
    the two-pass argmaxes of coarsening and refinement rely on.
    ``segment_ids`` must be int64 (``scatter_reduce_`` takes no other)."""
    if data.dtype.is_floating_point:
        identity = float("-inf")
    else:
        identity = torch.iinfo(data.dtype).min
    out = torch.full((num_segments,), identity, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce_(0, segment_ids, data, "amax",
                               include_self=True)


def makespan_tree(part, senders, receivers, edge_weight, node_weight,
                  subtree, F_l, k: int, speed=None,
                  device: DeviceLike = None) -> MakespanBreakdown:
    """M(P) for a tree topology. ``part[v]`` is a compute-bin index in
    [0, k). Arrays may be numpy or tensors; they are moved to ``device``
    (``None`` = CUDA). ``speed`` normalizes bin loads to
    ``comp(b)/speed(b)``. Comm comes from the ``quotient_link_loads``
    kernel with ``F_l = ones`` (raw volume), then scaled here."""
    return makespan_tree_with_quotient(part, senders, receivers, edge_weight,
                                       node_weight, subtree, F_l, k, speed,
                                       device)[0]


def makespan_tree_with_quotient(part, senders, receivers, edge_weight,
                                node_weight, subtree, F_l, k: int, speed=None,
                                device: DeviceLike = None
                                ) -> Tuple[MakespanBreakdown, torch.Tensor]:
    """:func:`makespan_tree` and the quotient matrix ``W`` ``[k, k]`` its
    comm was summed from (the kernel's own buffer, not a second scatter)."""
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.as_tensor(part, **i32)   # no copy if already there
    F_l = torch.as_tensor(F_l, **f32)
    speed = None if speed is None else torch.as_tensor(speed, **f32)
    comp = comp_loads(part, torch.as_tensor(node_weight, **f32), k, speed)
    comm, W = kops.link_loads_and_quotient(
        part, torch.as_tensor(senders, **i32),
        torch.as_tensor(receivers, **i32), torch.as_tensor(edge_weight, **f32),
        torch.as_tensor(subtree, **f32), torch.ones_like(F_l), k)
    return makespan_from_parts(comp, comm, F_l), W


def link_loads_routing(W: torch.Tensor,
                       path_incidence: torch.Tensor) -> torch.Tensor:
    """comm(l) under a routing oracle: ``R[i, j, l]`` fractional
    incidence. [L]"""
    return 0.5 * torch.einsum("ij,ijl->l", W, path_incidence)


def makespan_routing(part, senders, receivers, edge_weight, node_weight,
                     path_incidence, F_l, k: int, speed=None,
                     device: DeviceLike = None) -> MakespanBreakdown:
    """M(P) for a routing topology over its dense ``[k, k, L]`` path
    incidence, on ``device`` (``None`` = CUDA): the plain ``index_add_``
    quotient matrix pushed through ``R`` (one GEMM)."""
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.as_tensor(part, **i32)
    speed = None if speed is None else torch.as_tensor(speed, **f32)
    comp = comp_loads(part, torch.as_tensor(node_weight, **f32), k, speed)
    W = quotient_matrix(part, torch.as_tensor(senders, **i32),
                        torch.as_tensor(receivers, **i32),
                        torch.as_tensor(edge_weight, **f32), k)
    comm = link_loads_routing(W, torch.as_tensor(path_incidence, **f32))
    return makespan_from_parts(comp, comm, torch.as_tensor(F_l, **f32))


# ---------------------------------------------------------------------------
# Batched candidate scoring (the mapping search's hot path)
# ---------------------------------------------------------------------------

def permutation_link_loads(T: torch.Tensor, subtree: torch.Tensor,
                           device_to_bin: torch.Tensor) -> torch.Tensor:
    """comm(l) of ONE device->bin permutation from the traffic matrix. [L]

    With ``P`` the 0/1 matrix of the permutation, ``W = P T P^T``, so
    ``S W S^T`` collapses onto the gathered indicator
    ``Sg[l, d] = S[l, bin(d)]``: two ``[L, D]`` products against ``T``.
    ``T`` is symmetric per direction, as the arc-based quotient is; the
    0.5 counts each undirected edge once."""
    S_g = subtree[:, device_to_bin.long()]             # [L, D]
    rc = S_g @ (T.sum(dim=1) + T.sum(dim=0))
    cross = ((S_g @ T) * S_g).sum(dim=1)               # diag(Sg T Sg^T)
    return 0.5 * (rc - 2.0 * cross)


def permutation_link_loads_batch(device_to_bin: torch.Tensor,
                                 pair_u: torch.Tensor, pair_v: torch.Tensor,
                                 pair_w: torch.Tensor,
                                 lca_table: torch.Tensor,
                                 subtree: torch.Tensor,
                                 node_subtree: torch.Tensor,
                                 k: int, n_nodes: int) -> torch.Tensor:
    """Link loads ``[C, L]`` of a ``[C, D]`` batch of device->bin
    permutations, with no quotient matrix.

    Inputs: the unique nonzero traffic pairs ``(pair_u, pair_v)`` with
    weights ``pair_w`` ([E] each), the ``[k, k]`` bin-pair LCA table and
    the node-level subtree indicator ``[L, n_nodes]``. Per candidate and
    pair with endpoint bins ``(U, V)``, the XOR identity gives
    ``comm[c, l] = sum_e w_e (S[l,U] + S[l,V] - 2 S[l,U] S[l,V])`` and, on
    a tree, ``S[l,U] S[l,V] = S_node[l, lca(U, V)]``. So the loads are two
    flat ``index_add_`` bucketings over all candidates at once (pair
    weights by endpoint bin over ``C * k`` ids, by LCA node over
    ``C * n_nodes``), then two products against ``subtree.T`` and
    ``node_subtree.T`` (float32; TF32 is off for the whole port)."""
    c = device_to_bin.shape[0]
    e = pair_u.shape[0]
    d2b = device_to_bin.long()
    U = d2b[:, pair_u.long()]                          # [C, E] endpoint bins
    V = d2b[:, pair_v.long()]
    row = torch.arange(c, device=d2b.device)[:, None]
    ids = torch.cat([row * k + U, row * k + V], dim=1).reshape(-1)
    w2 = torch.cat([pair_w, pair_w])[None, :].expand(c, 2 * e).reshape(-1)
    ws = torch.zeros(c * k, dtype=pair_w.dtype, device=d2b.device)
    ws = ws.index_add_(0, ids, w2).view(c, k)
    lca = lca_table.long()[U, V]                       # [C, E]
    q = torch.zeros(c * n_nodes, dtype=pair_w.dtype, device=d2b.device)
    q = q.index_add_(0, (row * n_nodes + lca).reshape(-1),
                     pair_w[None, :].expand(c, e).reshape(-1))
    return ws @ subtree.T - 2.0 * (q.view(c, n_nodes) @ node_subtree.T)


def makespan_tree_batch(parts, senders, receivers, edge_weight, node_weight,
                        subtree, F_l, k: int, speed=None,
                        device: DeviceLike = None) -> MakespanBreakdown:
    """:func:`makespan_tree` over a ``[C, n]`` batch of assignments, the
    fields stacked along a leading ``C`` axis: the fallback for candidate
    sets that are not permutations of a traffic matrix. One
    ``quotient_link_loads`` launch per candidate on CUDA (C launches);
    ``speed`` is shared by all candidates."""
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    parts = torch.as_tensor(parts, **i32)
    args = (torch.as_tensor(senders, **i32), torch.as_tensor(receivers, **i32),
            torch.as_tensor(edge_weight, **f32),
            torch.as_tensor(node_weight, **f32),
            torch.as_tensor(subtree, **f32), torch.as_tensor(F_l, **f32))
    rows = [makespan_tree(p, *args, k=k, speed=speed, device=dev)
            for p in parts]
    return MakespanBreakdown(*(torch.stack(f) for f in zip(*rows)))


def total_cut(W: torch.Tensor) -> torch.Tensor:
    """Classic objective: sum of inter-bin edge weights (undirected)."""
    return 0.5 * (W.sum() - torch.trace(W))


def comm_volumes(part: torch.Tensor, senders: torch.Tensor,
                 receivers: torch.Tensor, node_weight: torch.Tensor,
                 k: int) -> torch.Tensor:
    """cvol(V_i) = sum over v in V_i of c(v) * D(v), with D(v) the number
    of foreign blocks adjacent to v (Hendrickson-Kolda). [k]

    ``adj[v, j]`` is the ``segment_max`` of ones over v's arcs into block
    j; empty segments hold -inf and clamp to 0. Entries are 0 or 1, so
    dropping the own block by subtraction is exact."""
    n = node_weight.shape[0]
    part = part.long()
    hits = segment_max(
        torch.ones(senders.shape[0], dtype=torch.float32,
                   device=node_weight.device),
        senders.long() * k + part[receivers.long()], n * k)
    adj = hits.clamp_min(0.0).view(n, k)
    d = adj.sum(1) - adj.gather(1, part[:, None])[:, 0]
    cvol = torch.zeros(k, dtype=node_weight.dtype, device=node_weight.device)
    return cvol.index_add_(0, part, node_weight * d)


def soft_cost(comp: torch.Tensor, comm: torch.Tensor, F_l: torch.Tensor,
              temp, speed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Smoothed bottleneck potential: temperature-scaled logsumexp over all
    load terms; -> true max as temp -> 0. ``comp`` is the RAW per-bin
    load; ``speed`` folds in ``comp/speed``."""
    comp_n = comp if speed is None else comp / speed
    loads = torch.cat([comp_n, F_l * comm])
    scale = torch.clamp_min(loads.detach().max(), 1e-9)
    t = max(float(temp), 1e-6)
    z = loads / (scale * t)
    return torch.logsumexp(z, dim=0) * scale * t


def load_gradients(comp: torch.Tensor, comm: torch.Tensor, F_l: torch.Tensor,
                   temp, speed: Optional[torch.Tensor] = None):
    """(g_comp [k], g_link [L]): d soft_cost / d RAW load, in closed form
    (softmax weights). With ``speed``, d soft / d comp(b) picks up the
    chain-rule 1/speed(b)."""
    comp_n = comp if speed is None else comp / speed
    loads = torch.cat([comp_n, F_l * comm])
    scale = torch.clamp_min(loads.max(), 1e-9)
    w = torch.softmax(loads / (scale * max(float(temp), 1e-6)), dim=0)
    k = comp.shape[0]
    g_comp = w[:k] if speed is None else w[:k] / speed
    return g_comp, w[k:] * F_l
