"""The paper's objective in PyTorch (tree machines).

Twin of the tree part of ``repro/core/objective.py``. Everything is written
over the quotient matrix ``W`` (inter-bin arc weights) and the subtree
indicator ``S``:

    comm(l) = sum_ij W_ij * (S_li XOR S_lj)
            = 0.5 * ((S @ r)_l + (S @ c)_l - 2 * diag(S @ W @ S^T)_l)

(r/c = row/column sums; the 0.5 counts each undirected edge once).
``makespan_tree`` takes its comm from the ``quotient_link_loads`` kernel
(``kernels.ops.link_loads``) called with ``F_l = ones``, so the breakdown
keeps the raw per-link volume that ``PartitionResult.comm`` and ``verify()``
need. ``soft_cost`` / ``load_gradients`` are the temperature-annealed
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
