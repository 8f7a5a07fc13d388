"""From partition to placement: block placement of vertex rows.

Twin of section 1 of ``repro/core/mapping.py`` (numpy, exact): an
arbitrary assignment ``part`` is realised by permuting rows so that block
``i`` of a row-blocked array holds exactly the vertices mapped to bin
``i``, bins padded to a common block size. On one card the same
permutation groups a graph's vertices by bin, which is what the GNN's BSR
layout sees (``kernels.bsr_spmm``). The logical-mesh search of the
reference's section 2 is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

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
