"""Paged KV cache: free-list allocator, page tables, placement hooks.

Twin of ``repro/serving/kv_cache.py``, with the pools as torch tensors on
the chosen device.

The pool holds ``n_pages`` fixed-size pages per layer plus one sentinel
page (index ``n_pages``) that idle decode slots read and write so the
batched step never branches on occupancy. A request owns
``ceil((prompt + gen) / page_size)`` pages for its whole lifetime —
reservation at admission is what makes the scheduler deadlock-free — and
its page table maps logical page ``i`` (tokens ``[i*P, (i+1)*P)``) to an
arbitrary physical page, so the pool can be reordered under a placement
without touching live requests' semantics.

Placement: every decode step each active request touches all its pages
(decode attention reads the full history), so pages of one request form a
clique in the co-access graph, weighted by how many steps they were read
together. ``page_traffic``/``page_weight`` expose that graph in exactly
the pages-as-rows shape ``PlacementSession.map_pages`` feeds the
partitioner; ``apply_placement`` realizes a page -> device assignment by
permuting physical pages into device-contiguous order (the order a
multi-device pool would shard on its page axis).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


class PagePoolExhausted(RuntimeError):
    """alloc() found fewer free pages than requested (backpressure)."""


class PageAllocator:
    """LIFO free-list allocator over ``n_pages`` physical pages.

    LIFO is deliberate: freshly freed pages are handed out first, so the
    alloc/free/alloc reuse property holds exactly and hot pages stay hot
    across request turnover.
    """

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._owned = np.zeros(n_pages, dtype=bool)
        # pages on failed devices: permanently out of the pool (fault
        # recovery); free + owned + dead partitions the pool
        self._dead = np.zeros(n_pages, dtype=bool)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_dead(self) -> int:
        return int(self._dead.sum())

    @property
    def n_usable(self) -> int:
        """Pool capacity excluding retired pages — the feasibility bound
        after a degrade (``n_free`` is the instantaneous bound)."""
        return self.n_pages - self.n_dead

    def alloc(self, n: int) -> List[int]:
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if n > len(self._free):
            raise PagePoolExhausted(
                f"requested {n} pages, {len(self._free)} free of "
                f"{self.n_pages}")
        pages = [self._free.pop() for _ in range(n)]
        self._owned[pages] = True
        return pages

    def free(self, pages: Sequence[int]) -> None:
        pages = list(pages)
        for p in pages:
            if not (0 <= p < self.n_pages):
                raise ValueError(f"page {p} outside pool of "
                                 f"{self.n_pages}")
            if not self._owned[p]:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            self._owned[p] = False
            self._free.append(p)

    def retire(self, pages: Sequence[int]) -> None:
        """Remove pages from the pool permanently (their device died).
        Pages must be unowned — the recovery path requeues/evicts the
        owning requests first — and a page retires at most once."""
        pages = list(pages)
        for p in pages:
            if not (0 <= p < self.n_pages):
                raise ValueError(f"page {p} outside pool of "
                                 f"{self.n_pages}")
            if self._owned[p]:
                raise ValueError(f"cannot retire owned page {p}: release "
                                 "its slot first")
            if self._dead[p]:
                raise ValueError(f"page {p} already retired")
        dead = set(pages)
        self._free = [p for p in self._free if p not in dead]
        self._dead[list(dead)] = True

    def owned_pages(self) -> np.ndarray:
        return np.nonzero(self._owned)[0]

    def dead_pages(self) -> np.ndarray:
        return np.nonzero(self._dead)[0]

    def relabel(self, perm: np.ndarray) -> None:
        """Apply a physical relabeling (old id -> new id) to the free list
        and ownership/dead maps — the allocator-side half of
        :meth:`PagedKVCache.apply_placement`."""
        perm = np.asarray(perm, dtype=np.int64)
        self._free = [int(perm[p]) for p in self._free]
        owned = np.zeros_like(self._owned)
        owned[perm[self._owned]] = True
        self._owned = owned
        dead = np.zeros_like(self._dead)
        dead[perm[self._dead]] = True
        self._dead = dead


@dataclasses.dataclass
class PagePlacement:
    """One page -> device assignment and its score on the traffic that
    produced it (what ``map_pages`` returns, what the engine applies)."""
    page_to_device: np.ndarray     # [n_pages]
    n_devices: int
    makespan: float                # of this assignment on the new traffic
    drift_ratio: float             # makespan(old asg) / makespan(this)
    replaced: bool                 # engine: whether it was applied


class PagedKVCache:
    """Page-table bookkeeping plus (optionally) the pooled K/V arrays.

    ``cfg=None`` builds the bookkeeping-only cache the scheduler tests
    drive — no pools. With a ``TransformerConfig`` the pools are zero
    tensors ``[n_layers, n_pages + 1, page_size, kh, dh]`` on ``device``
    (``None`` = CUDA; GQA layout; MLA's rank-compressed cache has no
    per-head pages and is not served by this path yet). The paged decode
    step writes them in place.
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 max_pages_per_req: int, cfg=None,
                 device: DeviceLike = None):
        if page_size < 1 or max_pages_per_req < 1 or n_slots < 1:
            raise ValueError("page_size, max_pages_per_req and n_slots "
                             "must all be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_slots = n_slots
        self.max_pages_per_req = max_pages_per_req
        self.sentinel = n_pages
        self.allocator = PageAllocator(n_pages)
        # host-side tables; the engine ships them to the decode step each
        # step (tiny: [n_slots, max_pages_per_req] int32)
        self.page_table = np.full((n_slots, max_pages_per_req),
                                  self.sentinel, dtype=np.int32)
        self.slot_pages: Dict[int, List[int]] = {}
        # measured access stats since the last placement epoch
        self.access_count = np.zeros(n_pages, dtype=np.float64)
        self.traffic = np.zeros((n_pages, n_pages), dtype=np.float64)
        self.cfg = cfg
        self.k_pool = None
        self.v_pool = None
        if cfg is not None:
            if cfg.mla:
                raise NotImplementedError(
                    "paged serving covers the GQA cache layout; MLA's "
                    "rank-compressed cache needs its own page shape "
                    "(ROADMAP: serving follow-up)")
            shape = (cfg.n_layers, n_pages + 1, page_size, cfg.n_kv_heads,
                     cfg.head_dim)
            dev = resolve_device(device)
            self.k_pool = torch.zeros(shape, dtype=cfg.dtype, device=dev)
            self.v_pool = torch.zeros(shape, dtype=cfg.dtype, device=dev)

    # -- allocation ------------------------------------------------------

    def pages_needed(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_size)

    def can_admit(self, n_tokens: int) -> bool:
        need = self.pages_needed(n_tokens)
        return (need <= self.max_pages_per_req
                and need <= self.allocator.n_free)

    def feasible(self, n_tokens: int) -> bool:
        """Whether a request of this size can EVER be admitted on the
        current (possibly degraded) pool — the ``can_admit`` bound with
        ``n_usable`` in place of the instantaneous free count. False means
        the request must be failed, not queued (it would head-block
        forever)."""
        need = self.pages_needed(n_tokens)
        return (need <= self.max_pages_per_req
                and need <= self.allocator.n_usable)

    def assign_slot(self, slot: int, n_tokens: int) -> List[int]:
        """Reserve every page of an ``n_tokens``-token request up front
        and point ``slot``'s page table at them. Raises
        :class:`PagePoolExhausted` under backpressure (caller keeps the
        request queued)."""
        if slot in self.slot_pages:
            raise ValueError(f"slot {slot} already holds pages")
        need = self.pages_needed(n_tokens)
        if need > self.max_pages_per_req:
            raise ValueError(
                f"request of {n_tokens} tokens needs {need} pages > "
                f"max_pages_per_req={self.max_pages_per_req}")
        pages = self.allocator.alloc(need)
        self.slot_pages[slot] = pages
        self.page_table[slot, :] = self.sentinel
        self.page_table[slot, :need] = pages
        return pages

    def release_slot(self, slot: int) -> List[int]:
        """Return a completed request's pages to the free list."""
        pages = self.slot_pages.pop(slot)
        self.allocator.free(pages)
        self.page_table[slot, :] = self.sentinel
        return pages

    # -- fault recovery --------------------------------------------------

    def fail_pages(self, pages: Sequence[int]) -> None:
        """A device died: its pages leave the pool permanently. Pages
        must already be unowned (the engine requeues/evicts affected
        requests first). Pool rows are zeroed — the data is gone, and a
        stale row must never be decoded against — and the dead pages'
        measured traffic is cleared so the page mapper only sees live
        co-access."""
        pages = [int(p) for p in pages]
        self.allocator.retire(pages)
        if pages:
            idx = np.asarray(pages, dtype=np.int64)
            self.access_count[idx] = 0.0
            self.traffic[idx, :] = 0.0
            self.traffic[:, idx] = 0.0
            if self.k_pool is not None:
                rows = torch.as_tensor(idx, device=self.k_pool.device)
                self.k_pool.index_fill_(1, rows, 0)
                self.v_pool.index_fill_(1, rows, 0)

    # -- measured traffic ------------------------------------------------

    def record_access(self, slot_tokens: Dict[int, int]) -> None:
        """One decode step touched, for each active slot, the pages
        holding its first ``n_tokens`` tokens: per-page counts += 1 and
        the co-access clique of those pages += 1."""
        for slot, n_tokens in slot_tokens.items():
            live = self.slot_pages.get(slot, [])
            k = min(self.pages_needed(n_tokens), len(live))
            idx = np.asarray(live[:k], dtype=np.int64)
            self.access_count[idx] += 1.0
            if k > 1:
                self.traffic[np.ix_(idx, idx)] += 1.0
        if self.traffic.shape[0]:
            np.fill_diagonal(self.traffic, 0.0)

    def page_traffic(self) -> np.ndarray:
        """Symmetric zero-diagonal [n_pages, n_pages] co-access matrix —
        the pages-as-rows graph ``map_pages`` partitions."""
        return self.traffic.copy()

    def page_weight(self) -> np.ndarray:
        """Per-page access counts (the partitioner's vertex weights)."""
        return self.access_count.copy()

    def reset_traffic(self) -> None:
        """Start a new placement epoch (drift is measured per epoch)."""
        self.access_count[:] = 0.0
        self.traffic[:] = 0.0

    # -- placement -------------------------------------------------------

    def apply_placement(self, page_to_device: np.ndarray) -> np.ndarray:
        """Reorder physical pages into device-contiguous order.

        Returns the relabeling ``perm`` (old physical id -> new physical
        id). Pool rows, every live page table, the free list and the
        access stats are all rewritten consistently; decode logits are
        invariant under the permutation (pinned by test)."""
        page_to_device = np.asarray(page_to_device)
        if page_to_device.shape != (self.n_pages,):
            raise ValueError(f"page_to_device must be [{self.n_pages}], "
                             f"got {list(page_to_device.shape)}")
        order = np.argsort(page_to_device, kind="stable")  # new -> old
        perm = np.empty(self.n_pages, dtype=np.int64)      # old -> new
        perm[order] = np.arange(self.n_pages)
        # page tables (sentinel is a fixed point)
        full_perm = np.append(perm, self.sentinel)
        self.page_table = full_perm[self.page_table].astype(np.int32)
        for slot, pages in self.slot_pages.items():
            self.slot_pages[slot] = [int(perm[p]) for p in pages]
        self.allocator.relabel(perm)
        self.access_count = self.access_count[order]
        self.traffic = self.traffic[np.ix_(order, order)]
        if self.k_pool is not None:
            gather = torch.as_tensor(np.append(order, self.sentinel),
                                     device=self.k_pool.device)
            self.k_pool = self.k_pool.index_select(1, gather)
            self.v_pool = self.v_pool.index_select(1, gather)
        return perm

    # -- invariant probes (tests / analysis) -----------------------------

    def live_page_sets(self) -> Dict[int, List[int]]:
        return {s: list(p) for s, p in self.slot_pages.items()}

    def check_invariants(self) -> None:
        """Cheap structural invariants, raised on violation: live page
        sets disjoint, tables consistent with ownership, free + owned +
        dead partitions the pool, no live request holds a retired page."""
        seen: Dict[int, int] = {}
        for slot, pages in self.slot_pages.items():
            for p in pages:
                if p in seen:
                    raise AssertionError(
                        f"page {p} owned by slots {seen[p]} and {slot}")
                seen[p] = slot
        owned = set(self.allocator.owned_pages().tolist())
        if set(seen) != owned:
            raise AssertionError(
                f"allocator/table ownership mismatch: {sorted(owned)} vs "
                f"{sorted(seen)}")
        dead = set(self.allocator.dead_pages().tolist())
        if dead & set(seen):
            raise AssertionError(
                f"retired pages still owned: {sorted(dead & set(seen))}")
        if self.allocator.n_free + len(owned) + len(dead) != self.n_pages:
            raise AssertionError("free + owned + dead != pool size")
