"""Collective accounting of a traced step: per-op link/operand byte totals
and the device-pair traffic matrix that feeds the mapping search. Twin of
``repro/launch/collectives.py``.

The reference parses the collectives out of a compiled SPMD module's HLO
text. The port runs the step once on meta DTensors over a ``DeviceMesh``
(``launch/placement.py``) and records each functional collective DTensor
issues with :class:`CollectiveRecorder`: the op, its result bytes, its
dtype and its process group, which :func:`groups_of` maps back to the
``[G, S]`` device groups of the mesh dim it spans. Ops are named as XLA
names them: ``all_gather_into_tensor`` -> ``all-gather``, ``all_reduce``
-> ``all-reduce``, ``reduce_scatter_tensor`` -> ``reduce-scatter``,
``all_to_all_single`` (and DTensor's ``shard_dim_alltoall``) ->
``all-to-all``.

From the records, :func:`parse_collectives` gives the reference's dict:
each collective's ring-model per-device link bytes (all-gather F(S-1)/S,
all-reduce 2F(S-1)/S, reduce-scatter F(S-1)/S of the full operand,
all-to-all F(S-1)/S, permute F; :func:`_link_bytes`, the reference's own
model) summed by op, and, with ``traffic=True``, the ``[D, D]`` matrix of
those bytes attributed to ring-neighbour pairs within each group
(:func:`add_group_traffic`). Devices are logical: index ``i`` is the
row-major position in the mesh, whatever rank backs it, as the reference's
partition ids are.

Two differences from the reference:

  * ``link_bf16`` equals ``link``. The reference halves float32
    collectives because XLA:CPU upcasts bf16 GEMM chains to float32 before
    its all-gathers; a torch trace has no such artefact, a collective's
    dtype is the dtype the step moves.
  * No trip scaling. The reference multiplies a scanned layer's
    collectives by the scan's trip count; the port's layers are unrolled,
    so the trace records every trip and ``scan_lengths`` multiplies
    nothing.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

_OP_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


def _link_bytes(op: str, result_bytes: int, s: int) -> Tuple[float, float]:
    """(per-device ring link bytes, operand bytes) per the module docstring."""
    f = float(result_bytes)
    if op == "all-gather":
        return f * (s - 1) / s, f / s
    if op == "all-reduce":
        return 2.0 * f * (s - 1) / s, f
    if op == "reduce-scatter":
        full = f * s
        return full * (s - 1) / s, full
    if op == "all-to-all":
        return f * (s - 1) / s, f
    return f, f                                   # collective-permute


def add_group_traffic(T: np.ndarray, groups: np.ndarray,
                      link_bytes: float) -> None:
    """Attribute one collective's per-device link bytes to ring-neighbour
    device pairs within each group (in place on ``T``).

    Mirrors ``core.mapping.collective_traffic_matrix`` exactly (the same
    ring roll, so a group along one mesh axis reproduces the per-axis model
    bit for bit): a device moving ``link_bytes`` within a size-S group
    charges ``link_bytes / (S - 1)`` to each of its ring neighbours,
    symmetric. Size-2 groups land twice on their single pair."""
    s = groups.shape[1]
    if s <= 1 or link_bytes <= 0:
        return
    per_pair = link_bytes / (s - 1)
    a = groups.ravel()
    b = np.roll(groups, -1, axis=1).ravel()
    keep = a != b
    a, b = a[keep], b[keep]
    np.add.at(T, (a, b), per_pair)
    np.add.at(T, (b, a), per_pair)


def _group_dims(mesh) -> Dict[str, Tuple[int, ...]]:
    """``{process-group name: (mesh dim,)}`` of every dim of ``mesh``."""
    return {mesh.get_group(i).group_name: (i,) for i in range(mesh.ndim)}


def _dims_of(mesh, group: str) -> Optional[Tuple[int, ...]]:
    """The mesh dim a process group (by name) spans: one of ``mesh``'s own
    dims' groups, or a group of ranks one of its dims spans. DTensor's
    caches take meshes of one rank grid and one set of names for one, so
    a DTensor built on a mesh made earlier with the same layout (a run
    that builds its mesh twice, each time with new process groups) may
    name that mesh's group."""
    dims = _group_dims(mesh).get(group)
    if dims is not None:
        return dims
    from torch.distributed.distributed_c10d import _resolve_process_group
    import torch.distributed as dist
    try:
        ranks = sorted(dist.get_process_group_ranks(
            _resolve_process_group(group)))
    except (KeyError, ValueError, RuntimeError):
        return None
    grid = np.asarray(mesh.mesh.tolist(), dtype=np.int64)
    for i in range(mesh.ndim):
        rows = np.moveaxis(grid, i, -1).reshape(-1, mesh.shape[i])
        if any(sorted(r) == ranks for r in rows.tolist()):
            return (i,)
    return None


def groups_of(mesh, group) -> np.ndarray:
    """The ``[G, S]`` groups of ranks a collective over ``group`` spans:
    the slices of the mesh's rank grid along the mesh dim (or dims) of
    ``group``, a process-group name of one of ``mesh``'s dims, a mesh dim
    name, or a tuple of dim names (several dims: the product group, the
    first-named dim outermost). Each row lists its ranks in the group's
    own rank order, the ring the collective runs."""
    names = tuple(mesh.mesh_dim_names)
    if isinstance(group, tuple):
        dims = tuple(names.index(g) for g in group)
    elif group in names:
        dims = (names.index(group),)
    else:
        dims = _dims_of(mesh, group)
        if dims is None:
            raise KeyError(f"process group {group!r} spans no dim of the "
                           f"mesh {names}")
    grid = np.asarray(mesh.mesh.tolist(), dtype=np.int64)
    grid = np.moveaxis(grid, dims, tuple(range(-len(dims), 0)))
    size = int(np.prod([mesh.shape[d] for d in dims]))
    return grid.reshape(-1, size)


class CollectiveRecorder(TorchDispatchMode):
    """Records each functional collective a step issues on ``mesh``.

    ``records`` holds one dict per collective: ``op`` (XLA's name),
    ``bytes`` (its result's bytes on one device), ``dtype``, ``group``
    (the process-group name), ``axis`` (the mesh dim it spans) and
    ``groups`` (the ``[G, S]`` logical device groups, :func:`groups_of`
    mapped through the mesh's order).

    DTensor redistributes inside its own dispatch, with the dispatch modes
    above it switched off. While a recorder is entered it wraps DTensor's
    ``redistribute_local_tensor``, so every redistribution, implicit or
    explicit, runs with the recorder on, and routes DTensor's shard-dim
    all-to-all to its collective op, which a CPU mesh (the fake world's)
    would otherwise replace by an all-gather and a chunk.
    """

    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh
        self.records: List[Dict[str, Any]] = []
        self._dims = _group_dims(mesh)
        order = np.asarray(mesh.mesh.reshape(-1).tolist(), dtype=np.int64)
        self._logical = np.empty(order.size, dtype=np.int64)
        self._logical[order] = np.arange(order.size)
        self._groups: Dict[str, np.ndarray] = {}
        self._depth = 0
        self._saved: List[Tuple[Any, str, Any]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = _OP_NAMES.get(func._opname) if func.namespace in (
            "_c10d_functional", "_dtensor") else None
        if op is not None:
            from repro_torch.kernels.cost_sites import paused
            with paused():
                self._record(op, out, args)
        return out

    def _record(self, op: str, out: torch.Tensor, args) -> None:
        group = [a for a in args if isinstance(a, str)][-1]
        if group not in self._groups:
            self._groups[group] = self._logical[groups_of(self.mesh, group)]
        dims = self._dims.get(group) or _dims_of(self.mesh, group) or ()
        self.records.append({
            "op": op, "bytes": int(out.numel()) * out.element_size(),
            "dtype": str(out.dtype).replace("torch.", ""),
            "group": group, "groups": self._groups[group],
            "axis": "x".join(self.mesh.mesh_dim_names[d] for d in dims)})

    def _patch(self):
        from torch.distributed.tensor import (_api, _dispatch,
                                              _redistribute, placement_types)
        from torch.utils._python_dispatch import \
            _get_current_dispatch_mode_stack
        inner = _redistribute.redistribute_local_tensor

        def redistribute_local_tensor(*args, **kwargs):
            # an explicit redistribute runs with the recorder still on the
            # stack; pushing it again would record each collective twice
            if self in _get_current_dispatch_mode_stack():
                return inner(*args, **kwargs)
            with self:
                return inner(*args, **kwargs)

        def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            return torch.ops._dtensor.shard_dim_alltoall(
                input, gather_dim, shard_dim,
                mesh.get_group(mesh_dim).group_name)

        for mod, name, fn in ((_redistribute, "redistribute_local_tensor",
                               redistribute_local_tensor),
                              (_dispatch, "redistribute_local_tensor",
                               redistribute_local_tensor),
                              (_api, "redistribute_local_tensor",
                               redistribute_local_tensor),
                              (placement_types, "shard_dim_alltoall",
                               shard_dim_alltoall)):
            self._saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)

    def __enter__(self):
        if self._depth == 0:
            self._patch()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                for mod, name, fn in reversed(self._saved):
                    setattr(mod, name, fn)
                self._saved.clear()

    def by_op(self) -> Dict[str, int]:
        """How many collectives of each op the recorder saw."""
        out: Dict[str, int] = {}
        for r in self.records:
            out[r["op"]] = out.get(r["op"], 0) + 1
        return dict(sorted(out.items()))


def parse_collectives(records: Sequence[Dict[str, Any]],
                      num_partitions: int,
                      traffic: bool = True) -> Dict[str, Any]:
    """Per-device collective byte totals by op (``link``, ``operand``,
    ``link_bf16`` = ``link``, ``count``) of recorded collectives, the link
    bytes by mesh axis and op (``link_by_axis``; the reference has no such
    field), and with ``traffic=True`` the ``[num_partitions,
    num_partitions]`` device-pair link-byte matrix (see the module
    docstring)."""
    link: Dict[str, float] = {}
    operand: Dict[str, float] = {}
    by_axis: Dict[str, Dict[str, float]] = {}
    T = np.zeros((num_partitions, num_partitions)) if traffic else None
    for r in records:
        groups: Optional[np.ndarray] = r.get("groups")
        if groups is None:
            groups = np.arange(num_partitions).reshape(1, -1)
        lb, ob = _link_bytes(r["op"], r["bytes"], groups.shape[1])
        link[r["op"]] = link.get(r["op"], 0.0) + lb
        operand[r["op"]] = operand.get(r["op"], 0.0) + ob
        ax = by_axis.setdefault(r.get("axis", ""), {})
        ax[r["op"]] = ax.get(r["op"], 0.0) + lb
        if traffic:
            add_group_traffic(T, groups, lb)
    out: Dict[str, Any] = {"link": link, "operand": operand,
                           "link_bf16": dict(link), "count": len(records),
                           "link_by_axis": by_axis}
    if traffic:
        out["traffic"] = T
    return out
