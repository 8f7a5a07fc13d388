"""Partition-sharded sparse embedding tables (rows-as-vertices).

Twin of ``repro/embed/sharded_table.py``. Rows are vertices, co-access
within one bag is an edge, measured access frequency is the vertex weight,
and the bins are the leaves of the machine tree:

* :class:`RowAccessStats` measures the row co-access graph from sampled
  batches (a bag's rows form a clique, capped at its ``max_clique``
  smallest ids), vectorised over the bags of a batch;
* :func:`plan_shards` runs the port's ``partition()`` over that graph on
  the machine tree, clamps row counts to capacity shares
  (:func:`_repair_capacity`) and returns a :class:`ShardPlan`: a
  row -> device assignment realised as a device-contiguous permutation;
* :class:`ShardedEmbeddingTable` holds the permuted table on the device
  plus the old -> new id translation; ``lookup_bags`` runs the
  ``gather_combine`` CUDA kernel and ``replicated()`` is the exact inverse;
  ``lookup`` / ``update_rows`` take original ids as tensors or arrays.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch.core import baselines
from repro_torch.core import machine as machine_lib
from repro_torch.core.draws import DrawSource
from repro_torch.core.partitioner import PartitionConfig, partition
from repro_torch.core.topology import guess_tree
from repro_torch.graph.graph import from_edges
from repro_torch.kernels import ops as kops

_NO_ROW = np.iinfo(np.int64).max


class RowAccessStats:
    """Measured row-access statistics over sampled batches.

    ``record`` accepts id arrays of shape [B, H] (bags, -1 padding) or
    [N] (point lookups: each id its own bag, so no co-access edges).
    ``counts`` is the partitioner's vertex weight; the pair counts are the
    co-access edge list, kept as int64 keys ``u * n_rows + v`` (u < v).
    """

    def __init__(self, n_rows: int, max_clique: int = 16):
        if n_rows < 1:
            raise ValueError(f"n_rows must be >= 1, got {n_rows}")
        self.n_rows = int(n_rows)
        self.max_clique = int(max_clique)
        self.counts = np.zeros(self.n_rows, dtype=np.float64)
        self.n_batches = 0
        self._keys = np.zeros(0, dtype=np.int64)     # unique, sorted
        self._w = np.zeros(0, dtype=np.float64)
        self._pending: List[np.ndarray] = []
        self._n_pending = 0

    def record(self, ids) -> None:
        """Count each bag's distinct rows once and each pair of its
        ``max_clique`` smallest distinct rows once, as the reference's
        per-bag loop does, over all bags at once."""
        ids = np.asarray(ids)
        if ids.ndim == 1:
            ids = ids[:, None]
        if ids.ndim != 2:
            raise ValueError(f"ids must be [B, H] or [N], got "
                             f"{list(ids.shape)}")
        self.n_batches += 1
        # per bag: distinct valid ids ascending, then _NO_ROW fill
        rows = np.where(ids >= 0, ids.astype(np.int64), _NO_ROW)
        rows.sort(axis=1)
        rows[:, 1:][rows[:, 1:] == rows[:, :-1]] = _NO_ROW
        rows.sort(axis=1)
        valid = rows != _NO_ROW
        if not valid.any():
            return
        top = int(rows[valid].max())
        if top >= self.n_rows:
            raise ValueError(f"row id {top} outside table of {self.n_rows} "
                             f"rows")
        self.counts += np.bincount(rows[valid], minlength=self.n_rows)
        c = min(self.max_clique, rows.shape[1])
        iu, ju = np.triu_indices(c, 1)
        both = valid[:, ju]            # valid ids are a prefix of each bag
        keys = rows[:, iu][both] * self.n_rows + rows[:, ju][both]
        self._pending.append(keys)
        self._n_pending += keys.size
        if self._n_pending > (1 << 24):
            self._compact()

    def _compact(self) -> None:
        if not self._pending:
            return
        keys = np.concatenate([self._keys, *self._pending])
        w = np.concatenate([self._w, np.ones(self._n_pending)])
        self._keys, inv = np.unique(keys, return_inverse=True)
        self._w = np.bincount(inv, weights=w,
                              minlength=self._keys.size).astype(np.float64)
        self._pending, self._n_pending = [], 0

    @property
    def n_pairs(self) -> int:
        self._compact()
        return int(self._keys.size)

    def pair_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(u, v, w) co-access edge list (u < v), in key order."""
        self._compact()
        return (self._keys // self.n_rows, self._keys % self.n_rows,
                self._w.copy())

    def top_rows(self, n: int) -> np.ndarray:
        """The ``n`` most-accessed rows, hottest first (cache warm set)."""
        n = min(int(n), self.n_rows)
        order = np.argsort(-self.counts, kind="stable")
        return order[:n]

    def device_traffic(self, row_to_device: np.ndarray, n_devices: int,
                       row_bytes: float = 1.0) -> np.ndarray:
        """[D, D] symmetric zero-diagonal co-access bytes under an
        assignment: the quotient of the co-access graph the partitioner
        minimises, in ``lint_traffic``-lawful shape."""
        row_to_device = np.asarray(row_to_device, dtype=np.int64)
        T = np.zeros((n_devices, n_devices), dtype=np.float64)
        u, v, w = self.pair_arrays()
        if u.size:
            du, dv = row_to_device[u], row_to_device[v]
            cross = du != dv
            np.add.at(T, (du[cross], dv[cross]), w[cross] * row_bytes)
            T = T + T.T
        return T


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One row -> device assignment realized as a device-contiguous
    permutation. ``order`` is new -> old (gather the original table with
    it), ``perm`` old -> new (translate original ids with it)."""
    row_to_device: np.ndarray       # [V] device per ORIGINAL row id
    n_devices: int
    order: np.ndarray               # [V] new physical row -> old row id
    perm: np.ndarray                # [V] old row id -> new physical row
    offsets: np.ndarray             # [D + 1] shard boundaries (new order)
    makespan: float
    machine: Optional[str] = None

    @property
    def n_rows(self) -> int:
        return int(self.row_to_device.shape[0])

    @property
    def shard_sizes(self) -> np.ndarray:
        """[D] rows per device."""
        return np.diff(self.offsets)

    def check(self) -> None:
        """Structural invariants, raised on violation: ``perm`` is a
        permutation inverse to ``order``, shards are contiguous in the
        new order, offsets match the assignment's bincount."""
        n, d = self.n_rows, self.n_devices
        if not np.array_equal(np.sort(self.perm), np.arange(n)):
            raise AssertionError("perm is not a permutation")
        if not np.array_equal(self.perm[self.order], np.arange(n)):
            raise AssertionError("perm is not the inverse of order")
        dev_new = self.row_to_device[self.order]
        if np.any(np.diff(dev_new) < 0):
            raise AssertionError("shards are not device-contiguous")
        sizes = np.bincount(self.row_to_device, minlength=d)
        if not np.array_equal(np.cumsum(np.concatenate([[0], sizes])),
                              self.offsets):
            raise AssertionError("offsets inconsistent with assignment")


def _capacity_blocks(nw: np.ndarray, topo) -> np.ndarray:
    """Degenerate fallback (no co-access edges yet, or fewer rows than
    bins): contiguous blocks whose *weighted* prefix tracks each bin's
    capacity share; uniform machines reduce to ``(arange(n) * k) // n``."""
    n, k = nw.shape[0], topo.k
    if topo.bin_speed is None:
        return (np.arange(n) * k) // max(n, 1)
    cap = np.asarray(topo.bin_speed, dtype=np.float64)
    targets = np.cumsum(cap)[:-1] / cap.sum()
    cum = (np.cumsum(nw) - 0.5 * nw) / max(float(nw.sum()), 1e-12)
    part = np.searchsorted(targets, cum, side="right")
    return np.clip(part, 0, k - 1)


def _repair_capacity(part: np.ndarray, counts: np.ndarray, topo,
                     slack: float) -> np.ndarray:
    """Clamp per-bin ROW COUNTS to capacity-proportional targets.

    Bins outside ``targets * (1 +- slack)`` donate their coldest rows
    (smallest access count, ties by row id) to the neediest bin until
    every bin is inside: the reference's move sequence, row for row. The
    reference rescans all rows for the donor's coldest on every move
    (O(n) each); here each bin keeps a min-heap of its rows' cold ranks,
    so a move pops the donor's minimum and pushes it onto the receiver.
    """
    part = np.asarray(part, dtype=np.int64).copy()
    n, k = part.shape[0], topo.k
    if n < k:
        return part
    cap = (np.asarray(topo.bin_speed, dtype=np.float64)
           if topo.bin_speed is not None else np.ones(k))
    targets = n * cap / cap.sum()
    hi = np.maximum(np.ceil(targets * (1.0 + slack)), 1.0)
    lo = np.maximum(np.floor(targets * (1.0 - slack)), 1.0)
    sizes = np.bincount(part, minlength=k).astype(np.float64)
    cold = np.argsort(counts, kind="stable")      # rank -> row
    heaps = None                                  # bin -> heap of ranks
    for _ in range(2 * n):
        under = sizes < lo
        over = sizes > hi
        if not under.any() and not over.any():
            break
        # neediest receiver; donor = most-over bin (else the fullest bin
        # that can give a row up without dropping under its own floor)
        dst = int(np.argmin(sizes / np.maximum(targets, 1e-12)))
        if over.any():
            src = int(np.argmax(np.where(over, sizes / targets, -1.0)))
        else:
            can_give = sizes > lo
            if not can_give.any():
                break
            src = int(np.argmax(np.where(
                can_give, sizes / np.maximum(targets, 1e-12), -1.0)))
        if src == dst:
            break
        if heaps is None:
            # ranks grouped by bin, ascending within each: sorted lists
            # are valid heaps
            by_bin = np.argsort(part[cold], kind="stable")
            ends = np.cumsum(np.bincount(part, minlength=k))
            heaps = [h.tolist() for h in np.split(by_bin, ends[:-1])]
        if not heaps[src]:
            break
        rank = heapq.heappop(heaps[src])
        heapq.heappush(heaps[dst], rank)
        part[cold[rank]] = dst
        sizes[src] -= 1.0
        sizes[dst] += 1.0
    return part


def plan_shards(stats: RowAccessStats, *, machine=None,
                n_devices: Optional[int] = None, seed: int = 0,
                seeds: int = 1, balance_slack: float = 0.2,
                draws: Optional[DrawSource] = None,
                device: DeviceLike = None) -> ShardPlan:
    """Partition table rows over the machine tree's leaves.

    Vertex weight is the measured access count (floored so cold rows
    still spread), the co-access pairs are the edges, and heterogeneous
    presets balance ``comp(b)/speed(b)``. Degenerate inputs fall back to
    capacity-proportional contiguous blocks. Row COUNTS per bin are then
    clamped to the bin's capacity share within ``balance_slack``.
    ``partition()`` and the scorecard run on ``device`` (``None`` = CUDA);
    ``draws`` replaces the partitioner's random source.
    """
    spec = machine_lib.resolve(machine)
    if spec is not None:
        topo = spec.tree()
    else:
        if not n_devices or n_devices < 1:
            raise ValueError("plan_shards needs a machine or n_devices")
        topo = guess_tree(int(n_devices))
    k = topo.k
    n = stats.n_rows
    nw = stats.counts.astype(np.float64)
    # every row gets a positive weight so never-sampled rows still spread
    nw = np.maximum(nw, max(float(nw.max()), 1.0) * 1e-3)
    u, v, w = stats.pair_arrays()
    g = (from_edges(n, u, v, w.astype(np.float32), nw.astype(np.float32))
         if u.size else None)
    if g is None or n <= k:
        part = _capacity_blocks(nw, topo)
    else:
        res = partition(g, topo, PartitionConfig(seed=seed, seeds=seeds),
                        device=device, draws=draws)
        part = res.part
    part = _repair_capacity(np.asarray(part, dtype=np.int64),
                            stats.counts, topo, balance_slack)
    makespan = (baselines.score_all(g, topo, part, device)["makespan"]
                if g is not None else 0.0)
    order = np.argsort(part, kind="stable")          # new -> old
    perm = np.empty(n, dtype=np.int64)               # old -> new
    perm[order] = np.arange(n)
    sizes = np.bincount(part, minlength=k)
    offsets = np.cumsum(np.concatenate([[0], sizes]))
    return ShardPlan(row_to_device=part, n_devices=int(k), order=order,
                     perm=perm, offsets=offsets, makespan=makespan,
                     machine=spec.name if spec is not None else None)


def identity_plan(n_rows: int, n_devices: int = 1) -> ShardPlan:
    """Replicated/no-op plan: every row on device 0 of a 1-bin machine
    (or balanced blocks for ``n_devices > 1``), identity permutation."""
    part = (np.arange(n_rows) * n_devices) // max(n_rows, 1)
    order = np.arange(n_rows, dtype=np.int64)
    sizes = np.bincount(part, minlength=n_devices)
    return ShardPlan(row_to_device=part.astype(np.int64),
                     n_devices=int(n_devices), order=order,
                     perm=order.copy(),
                     offsets=np.cumsum(np.concatenate([[0], sizes])),
                     makespan=0.0)


class ShardedEmbeddingTable:
    """The device-contiguous permuted table plus the id translation.

    ``data[plan.perm[i]]`` is original row ``i``: lookups translate ids
    through ``perm`` (int32, on the table's device) exactly once.
    """

    def __init__(self, table, plan: ShardPlan, *, permuted: bool = False):
        table = torch.as_tensor(table).detach()
        if table.shape[0] != plan.n_rows:
            raise ValueError(f"table has {table.shape[0]} rows, plan "
                             f"covers {plan.n_rows}")
        dev = table.device
        self.plan = plan
        self.data = (table if permuted else
                     table[torch.as_tensor(plan.order, device=dev)])
        self._perm = torch.as_tensor(plan.perm, dtype=torch.int32,
                                     device=dev)

    @property
    def n_rows(self) -> int:
        return self.plan.n_rows

    @property
    def dim(self) -> int:
        return int(self.data.shape[1])

    @property
    def row_bytes(self) -> int:
        return self.dim * self.data.element_size()

    def translate(self, ids: torch.Tensor) -> torch.Tensor:
        """Original ids -> physical rows (negative padding preserved)."""
        phys = self._perm[ids.clamp_min(0)].to(ids.dtype)
        return torch.where(ids >= 0, phys, ids)

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids, device=self.data.device).long()

    def lookup(self, ids) -> torch.Tensor:
        """[...,] original ids -> [..., E] rows (ids must be >= 0)."""
        return self.data[self._perm[self._ids(ids)]]

    def lookup_bags(self, ids: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
        """[B, H] bags (-1 padding, per-slot weights) -> [B, E] through the
        fused ``gather_combine`` kernel (plain version on the CPU)."""
        return kops.gather_combine(self.data, self._perm[ids.clamp_min(0)],
                                   weights)

    def update_rows(self, ids, values: torch.Tensor) -> None:
        """Write new values into the rows named by ORIGINAL ids, in place
        (the reference replaces its immutable array; a table built with
        ``permuted=True`` shares the caller's tensor)."""
        self.data[self._perm[self._ids(ids)]] = values

    def replicated(self) -> torch.Tensor:
        """The full table back in original row order (inverse of the
        placement permutation; bitwise)."""
        return self.data[self._perm]

    def device_of(self, ids) -> np.ndarray:
        """Owning device per ORIGINAL row id (host-side)."""
        return self.plan.row_to_device[np.asarray(ids)]

    def rows_per_device(self) -> np.ndarray:
        return self.plan.shard_sizes
