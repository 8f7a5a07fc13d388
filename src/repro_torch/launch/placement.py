"""The serving engine's page mapper: twin of ``PlacementSession``'s
``map_pages`` and the search fields it reads (``repro/launch/placement.py``).

The reference's session also compiles cells, parses XLA collectives and
searches mesh orders; on one card there is no mesh, so only the
pages-as-rows placement of the paged KV pool is ported. ``map_pages``
places the pages of the pool as the rows of a graph with the port's
``partition()`` (on the session's device), ``score_all``, ``guess_tree``
and ``from_edges``: the paper's makespan objective inside the server.
"""
from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np

from repro_torch import DeviceLike
from repro_torch.core import machine as machine_lib


class PlacementSession:
    """The search settings ``map_pages`` reads (``seed``, the default
    ``machine``; the mesh search's ``map_restarts`` / ``recursive`` come
    with it) and the device the partitioner runs on (``None`` = CUDA).
    ``n_map_pages`` / ``map_pages_s`` count the calls and their wall
    seconds."""

    def __init__(self, seed: int = 0, machine: Optional[Any] = None,
                 device: DeviceLike = None):
        self.machine = machine_lib.resolve(machine)
        self.seed = seed
        self.device = device
        self.n_map_pages = 0
        self.map_pages_s = 0.0

    def map_pages(self, traffic: np.ndarray, *,
                  node_weight: Optional[np.ndarray] = None,
                  n_devices: Optional[int] = None,
                  machine: Optional[Any] = None,
                  current: Optional[np.ndarray] = None,
                  seeds: int = 1):
        """Pages-as-rows placement for the serving KV pool.

        ``traffic`` is the measured [n_pages, n_pages] co-access matrix
        (``serving.PagedKVCache.page_traffic``), ``node_weight`` the
        per-page access counts; vertices are pages and the bins are the
        leaves of the machine tree (``machine``/session default, else
        ``guess_tree(n_devices)``), so the full multilevel partitioner
        optimizes exactly the paper's capacity-normalized makespan over
        hot pages. The matrix is linted first (square, finite, symmetric,
        zero diagonal) — a malformed matrix is a serving bug, not a
        placement preference.

        ``current`` (the live assignment) prices drift:
        ``drift_ratio = makespan(current on this traffic) /
        makespan(searched)``; the engine re-places when it exceeds
        ``1 + drift_threshold``. ``seeds`` is the partitioner's best-of-S
        refinement (``PartitionConfig.seeds``). Returns a
        ``serving.kv_cache.PagePlacement``.
        """
        from repro_torch.analysis import shard_lint
        from repro_torch.core import baselines
        from repro_torch.core.partitioner import PartitionConfig, partition
        from repro_torch.core.topology import guess_tree
        from repro_torch.graph.graph import from_edges
        from repro_torch.serving.kv_cache import PagePlacement

        t0 = time.perf_counter()
        traffic = np.asarray(traffic, dtype=np.float64)
        findings = shard_lint.lint_traffic(traffic, subject="page-traffic")
        errors = [f for f in findings if f.severity == "error"]
        if errors:
            raise ValueError("malformed page-traffic matrix: "
                             + "; ".join(f.message for f in errors))
        n = traffic.shape[0]
        spec = machine_lib.resolve(machine) or self.machine
        if spec is not None:
            topo = spec.tree()
        else:
            if not n_devices or n_devices < 1:
                raise ValueError("map_pages needs a machine or n_devices")
            topo = guess_tree(int(n_devices))
        if topo.bin_speed is not None and not (topo.bin_speed > 0).all():
            raise ValueError("zero-capacity bin reached the page mapper — "
                             "degrade() masks dead leaves; never zero a "
                             "bin_speed entry")
        k = topo.k
        nw = (np.asarray(node_weight, dtype=np.float64)
              if node_weight is not None else traffic.sum(axis=1))
        # every page gets a positive weight so cold pages still spread
        nw = np.maximum(nw, max(float(nw.max()), 1.0) * 1e-3)
        iu = np.triu_indices(n, 1)
        w = traffic[iu]
        nz = w > 0
        g = (from_edges(n, iu[0][nz], iu[1][nz], w[nz].astype(np.float32),
                        nw.astype(np.float32)) if nz.any() else None)
        if g is None or n <= k:
            # degenerate epochs (no co-access yet, or fewer pages than
            # bins): balanced contiguous blocks
            part = (np.arange(n) * k) // max(n, 1)
            makespan = (float(baselines.score_all(
                g, topo, part, device=self.device)["makespan"])
                if g is not None else 0.0)
        else:
            res = partition(g, topo, PartitionConfig(seed=self.seed,
                                                     seeds=seeds),
                            device=self.device)
            part, makespan = res.part, float(res.makespan)
        drift = float("inf")
        if current is not None:
            current = np.asarray(current)
            if current.shape != (n,):
                raise ValueError(f"current assignment must be [{n}], got "
                                 f"{list(current.shape)}")
            if g is None:
                drift = 1.0
            else:
                cur_ms = baselines.score_all(g, topo, current,
                                             device=self.device)["makespan"]
                drift = (float(cur_ms) / makespan if makespan > 0
                         else (1.0 if cur_ms <= 0 else float("inf")))
        self.n_map_pages += 1
        self.map_pages_s += time.perf_counter() - t0
        return PagePlacement(page_to_device=np.asarray(part,
                                                       dtype=np.int64),
                             n_devices=int(k), makespan=makespan,
                             drift_ratio=drift, replaced=False)
