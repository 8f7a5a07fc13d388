"""Hot-row device cache and touched-rows-only (sparse) optimizer updates.
Twin of ``repro/embed/hot_cache.py``.

The cache models what a multi-device embedding deployment keeps resident
next to the compute: the measured-hottest rows (static policy) or an LRU
admission set. Hits cost nothing; a miss fetches the row from its owning
shard — ``traffic[requester, owner] += row_bytes`` into the same
``[D, D]`` symmetric zero-diagonal matrix shape the mapping search scores
(``shard_lint.lint_traffic`` lawful) — and the replicated baseline's cost
model (:func:`replicated_update_traffic`: every touched row's gradient
broadcast to the other ``D - 1`` replicas) is what the bench compares
against.

Sparse optimizer: rowwise Adagrad (one accumulator scalar per row),
chosen over AdamW for the tables because a zero-gradient row is an exact
no-op, so the touched-rows-only update is bitwise the dense full-table
update. Three call shapes share one formula (:func:`_row_step`), so that
holds by construction:

* :func:`dense_row_update`   — full table, grads dense;
* :func:`masked_row_update`  — full table, rows with an all-zero gradient
  selected unchanged (what ``make_embed_train_step`` uses);
* :func:`sparse_row_update`  — gather/scatter over explicit unique rows
  (the host-driven cache path).

The cache's bookkeeping is the reference's, on the host; its rows are a
tensor on the table's device. A row admitted by a miss is copied in from
the table lazily, all pending copies in one gather before the cache's
values are next read (the reference copies each at admission): nothing
writes a row between its admission and that gather, so the values are the
same.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Set

import numpy as np
import torch


# ---------------------------------------------------------------------------
# rowwise Adagrad (the sparse-friendly table optimizer)
# ---------------------------------------------------------------------------

def _row_step(vals: torch.Tensor, accum_rows: torch.Tensor,
              grads: torch.Tensor, lr: float, eps: float):
    """One rowwise-Adagrad step on a stack of rows. Every update path
    calls this, so dense/masked/sparse agree bitwise wherever the gradient
    is nonzero (and a zero gradient leaves the row and its accumulator
    exactly unchanged). ``lr`` divides as a tensor, as the reference
    divides."""
    g32 = grads.to(torch.float32)
    g2 = torch.mean(torch.square(g32), dim=-1)               # [U]
    accum_new = accum_rows + g2
    scale = accum_new.new_tensor(lr) / (torch.sqrt(accum_new) + eps)
    vals_new = (vals.to(torch.float32)
                - scale[..., None] * g32).to(vals.dtype)
    return vals_new, accum_new


def dense_row_update(table, accum, grads, *, lr: float = 0.05,
                     eps: float = 1e-8):
    """Full-table reference: (table', accum'). Zero-gradient rows come
    back unchanged (x - 0.0 == x, accum + 0.0 == accum)."""
    return _row_step(table, accum, grads, lr, eps)


def masked_row_update(table, accum, grads, *, lr: float = 0.05,
                      eps: float = 1e-8):
    """Rows with an all-zero gradient are selected unchanged (a
    where-mask, no dynamic shapes). Bitwise :func:`dense_row_update`."""
    touched = torch.any(grads != 0, dim=-1)
    vals_new, accum_new = _row_step(table, accum, grads, lr, eps)
    return (torch.where(touched[..., None], vals_new, table),
            torch.where(touched, accum_new, accum))


def sparse_row_update(table, accum, rows, grads, *, lr: float = 0.05,
                      eps: float = 1e-8):
    """Touched-rows-only gather/scatter: ``rows`` [U] UNIQUE row ids,
    ``grads`` [U, E]; new tensors, the inputs unchanged. Bitwise the dense
    update whose gradient is zero outside ``rows``."""
    rows = torch.as_tensor(rows, device=table.device).long()
    vals_new, accum_new = _row_step(table[rows], accum[rows], grads,
                                    lr, eps)
    return (table.index_copy(0, rows, vals_new),
            accum.index_copy(0, rows, accum_new))


def requester_of(n: int, n_devices: int) -> np.ndarray:
    """[n] requesting device per example — contiguous blocks, the
    row-major data-parallel batch split."""
    return (np.arange(n) * n_devices) // max(n, 1)


def replicated_update_traffic(ids: np.ndarray, requester: np.ndarray,
                              n_devices: int, row_bytes: float
                              ) -> np.ndarray:
    """[D, D] cost of keeping a replicated table consistent for one batch:
    each unique touched (row, requester) gradient leaves its requester for
    the other ``D - 1`` replicas. The reference adds ``row_bytes`` per
    touch and pair in a loop; with ``c[r]`` touches requested by ``r``
    that is ``T[i, j] = row_bytes * (c[i] + c[j])`` off the diagonal,
    exactly (integer multiples of ``row_bytes`` in float64)."""
    ids = np.asarray(ids).ravel()
    requester = np.asarray(requester).ravel()
    valid = ids >= 0
    key = np.unique(ids[valid].astype(np.int64) * n_devices
                    + requester[valid].astype(np.int64))
    c = np.bincount(key % n_devices, minlength=n_devices).astype(np.float64)
    T = float(row_bytes) * (c[:, None] + c[None, :])
    np.fill_diagonal(T, 0.0)
    return T


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

class HotRowCache:
    """Static-or-LRU hot-row cache over a ``ShardedEmbeddingTable``.

    Bookkeeping is host-side (dict + OrderedDict LRU); row values live in
    a tensor on the table's device. A cached row's value is authoritative
    — updates land in the cache slot and are flushed to the backing shard
    on eviction (``pending`` tracks dirty slots), so an eviction never
    loses an update.

    Counters: ``lookups == hits + misses`` (per id occurrence),
    ``evictions``, ``flushes``; ``traffic`` is the measured ``[D, D]``
    matrix (miss fetches + update writebacks between requester and
    owner). ``check_invariants`` raises on any violation.
    """

    def __init__(self, table, n_cache: int, policy: str = "lru"):
        if policy not in ("lru", "static"):
            raise ValueError(f"policy must be 'lru' or 'static', "
                             f"got {policy!r}")
        if n_cache < 0:
            raise ValueError(f"n_cache must be >= 0, got {n_cache}")
        self.table = table
        self.policy = policy
        self.n_cache = int(n_cache)
        self.n_devices = table.plan.n_devices
        self.device = table.data.device
        self.cache = (torch.zeros((self.n_cache, table.dim),
                                  dtype=table.data.dtype, device=self.device)
                      if self.n_cache else None)
        self.row_of = np.full(self.n_cache, -1, dtype=np.int64)
        self.slot_of: Dict[int, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._free = list(range(self.n_cache - 1, -1, -1))
        self.pending: Set[int] = set()
        # slots admitted but not yet copied in from the table: slot -> row
        self._to_load: Dict[int, int] = {}
        # requester that last wrote each slot (writeback attribution)
        self._writer = np.zeros(self.n_cache, dtype=np.int64)
        self.lookups = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.flushes = 0
        self.traffic = np.zeros((self.n_devices, self.n_devices),
                                dtype=np.float64)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.int64),
                               device=self.device)

    def _load(self) -> None:
        """Copy every admitted-but-unloaded row in from the table, in one
        gather."""
        if self._to_load:
            slots = np.fromiter(self._to_load.keys(), dtype=np.int64)
            rows = np.fromiter(self._to_load.values(), dtype=np.int64)
            self._to_load.clear()
            self.cache[self._t(slots)] = self.table.lookup(rows)

    # -- admission -------------------------------------------------------

    def _admit(self, row: int, requester: int) -> int:
        """Install ``row`` (original id) into a slot, evicting LRU if
        full. Returns the slot."""
        if not self._free:
            self._evict_one()
        slot = self._free.pop()
        self.slot_of[row] = slot
        self.row_of[slot] = row
        self._lru[row] = None
        self._writer[slot] = requester
        self._to_load[slot] = row
        return slot

    def _evict_one(self) -> None:
        row, _ = self._lru.popitem(last=False)
        slot = self.slot_of.pop(row)
        self._to_load.pop(slot, None)
        if slot in self.pending:
            self._flush_slot(slot, row)
        self.row_of[slot] = -1
        self._free.append(slot)
        self.evictions += 1

    def _flush_slot(self, slot: int, row: int) -> None:
        self.table.update_rows(np.asarray([row]), self.cache[slot][None])
        self.pending.discard(slot)
        self.flushes += 1
        owner = int(self.table.plan.row_to_device[row])
        writer = int(self._writer[slot])
        if owner != writer:
            rb = float(self.table.row_bytes)
            self.traffic[writer, owner] += rb
            self.traffic[owner, writer] += rb

    def warm(self, rows: np.ndarray) -> None:
        """Preload rows (hottest-first from ``RowAccessStats.top_rows``)
        without counting traffic — the static policy's working set."""
        for row in np.asarray(rows)[:self.n_cache]:
            row = int(row)
            if row not in self.slot_of:
                self._admit(row, requester=int(
                    self.table.plan.row_to_device[row]))

    # -- the hot path ----------------------------------------------------

    def lookup(self, ids, requester: Optional[np.ndarray] = None
               ) -> torch.Tensor:
        """[N] original ids (>= 0) -> [N, E] rows. ``requester`` [N]
        device issuing each lookup (defaults to the contiguous
        data-parallel split). Bookkeeping per occurrence; values come
        from the cache for hits (authoritative under pending updates) and
        from the owning shard for misses."""
        ids = np.asarray(ids).ravel()
        if requester is None:
            requester = requester_of(ids.shape[0], self.n_devices)
        requester = np.asarray(requester).ravel()
        owners = self.table.plan.row_to_device[ids]
        rb = float(self.table.row_bytes)
        for i, row in enumerate(ids.tolist()):
            self.lookups += 1
            if row in self.slot_of:
                self.hits += 1
                self._lru.move_to_end(row)
                continue
            self.misses += 1
            req, owner = int(requester[i]), int(owners[i])
            if owner != req:
                self.traffic[req, owner] += rb
                self.traffic[owner, req] += rb
            if self.n_cache and self.policy == "lru":
                self._admit(row, req)
        # resolve values against the FINAL slot map: a slot recorded
        # mid-loop can be recycled by a later admission in the same call,
        # and a row evicted mid-call was flushed, so the backing table is
        # authoritative for everything not cached right now
        vals = self.table.lookup(ids)
        hit_pos, hit_slot = [], []
        for i, row in enumerate(ids.tolist()):
            slot = self.slot_of.get(row)
            if slot is not None:
                hit_pos.append(i)
                hit_slot.append(slot)
        if hit_pos:
            self._load()
            vals[self._t(hit_pos)] = self.cache[self._t(hit_slot)]
        return vals

    # -- updates ---------------------------------------------------------

    def apply_grads(self, rows: np.ndarray, grads, accum,
                    requester: Optional[np.ndarray] = None, *,
                    lr: float = 0.05, eps: float = 1e-8) -> torch.Tensor:
        """Sparse rowwise-Adagrad over UNIQUE original ``rows`` [U] with
        ``grads`` [U, E]; returns the updated ``accum`` [V] (a new
        tensor). Cached rows update in place (marked pending, flushed on
        eviction); uncached rows scatter straight into the shard with a
        writeback charge."""
        rows = np.asarray(rows).ravel()
        if np.unique(rows).shape[0] != rows.shape[0]:
            raise ValueError("apply_grads needs unique rows (aggregate "
                             "duplicate ids first)")
        if requester is None:
            requester = requester_of(rows.shape[0], self.n_devices)
        grads = torch.as_tensor(grads, device=self.device)
        accum = torch.as_tensor(accum, device=self.device).clone()
        cached = np.asarray([r in self.slot_of for r in rows.tolist()],
                            dtype=bool)
        rb = float(self.table.row_bytes)
        if cached.any():
            self._load()
            idx = np.nonzero(cached)[0]
            slots = np.asarray([self.slot_of[int(rows[i])] for i in idx])
            vals_new, acc_new = _row_step(
                self.cache[self._t(slots)], accum[self._t(rows[idx])],
                grads[self._t(idx)], lr, eps)
            self.cache[self._t(slots)] = vals_new
            accum[self._t(rows[idx])] = acc_new
            for i, slot in zip(idx, slots.tolist()):
                self.pending.add(int(slot))
                self._writer[slot] = int(requester[i])
        if (~cached).any():
            idx = np.nonzero(~cached)[0]
            sub = rows[idx]
            # accum is keyed by ORIGINAL id; table rows by physical slot
            phys = self._t(self.table.plan.perm[sub])
            vals_new, acc_new = _row_step(
                self.table.data[phys], accum[self._t(sub)],
                grads[self._t(idx)], lr, eps)
            self.table.data[phys] = vals_new
            accum[self._t(sub)] = acc_new
            for i in idx:
                req = int(requester[i])
                owner = int(self.table.plan.row_to_device[rows[i]])
                if owner != req:
                    self.traffic[req, owner] += rb
                    self.traffic[owner, req] += rb
        return accum

    def flush(self) -> None:
        """Write every pending cached row back to its shard."""
        for slot in sorted(self.pending):
            self._flush_slot(slot, int(self.row_of[slot]))

    def replicated(self) -> torch.Tensor:
        """Full table in original order with all cached updates applied
        (flushes first) — the ground truth tests compare against."""
        self.flush()
        return self.table.replicated()

    # -- probes ----------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    @property
    def n_cached(self) -> int:
        return len(self.slot_of)

    def traffic_bytes(self) -> float:
        return float(self.traffic.sum()) / 2.0

    def check_invariants(self) -> None:
        """Raised on violation: slot/row maps are a bijection bounded by
        the pool, LRU tracks exactly the occupied rows, pending and
        to-load slots are occupied, hits + misses == lookups, free +
        occupied partitions the pool, and the traffic matrix is lawful."""
        if len(self.slot_of) > self.n_cache:
            raise AssertionError(
                f"{len(self.slot_of)} rows cached in a "
                f"{self.n_cache}-slot pool")
        for row, slot in self.slot_of.items():
            if self.row_of[slot] != row:
                raise AssertionError(
                    f"slot {slot} maps to row {self.row_of[slot]}, "
                    f"expected {row}")
        occupied = set(self.slot_of.values())
        if len(occupied) != len(self.slot_of):
            raise AssertionError("two rows share a cache slot")
        if set(self._lru.keys()) != set(self.slot_of.keys()):
            raise AssertionError("LRU book does not match cached rows")
        if not self.pending <= occupied:
            raise AssertionError(
                f"pending slots {sorted(self.pending - occupied)} are "
                "not occupied")
        if not set(self._to_load) <= occupied or any(
                self.row_of[s] != r for s, r in self._to_load.items()):
            raise AssertionError("a slot to load is not its row's")
        if len(self._free) + len(occupied) != self.n_cache:
            raise AssertionError("free + occupied != pool size")
        if self.hits + self.misses != self.lookups:
            raise AssertionError(
                f"hits {self.hits} + misses {self.misses} != lookups "
                f"{self.lookups}")
        t = self.traffic
        if not np.all(np.isfinite(t)) or float(t.min()) < 0.0:
            raise AssertionError("traffic matrix has negative/NaN bytes")
        if float(np.abs(np.diag(t)).max(initial=0.0)) > 0.0:
            raise AssertionError("nonzero self-traffic on the diagonal")
        if float(np.abs(t - t.T).max(initial=0.0)) > 0.0:
            raise AssertionError("traffic matrix is not symmetric")
