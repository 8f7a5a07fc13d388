"""Block-sparse SpMM over BSR blocks (GIN's sum aggregation ``A @ X``).

Replaces the Pallas kernel ``repro/kernels/bsr_spmm.py:bsr_spmm`` with
``csrc/bsr_spmm.cu``:

    out[r*R:(r+1)*R, f] = sum over the nonzero blocks t of block row r of
                          A_t @ x[cols[t]*R:(cols[t]+1)*R, f]

The TPU kernel walks the blocks as a sequential grid axis into a resident
output tile; Hopper has no ordered grid, so one CUDA block per (block row,
row tile, feature tile) walks ``row_ptr[r] .. row_ptr[r+1]`` itself. It
reads only the 16-column slabs of ``A_t`` that hold a nonzero in its row
tile (the layout's ``occupancy``: one bit per 16 x 16 sub-block), through
a ring of shared-memory buffers filled by ``cp.async`` several slabs
ahead, and accumulates in registers in full float32 FMAs (TF32 stays off,
as the reference computes in f32). Each output is written once, in a fixed
order: no atomics, deterministic, and for finite ``x`` bitwise the dense
walk's result.

Bound on the H100 at GIN-TU's bulk batch (3,840 block rows, 11,008 blocks
of 128 x 128, 1,947,010 nonzeros, F = 64): 0.080 ms for ``x`` and ``out``
once each and every nonzero's value and position (267 MB at 3.35 TB/s),
against 0.004 ms for the product's 0.25 GFLOP at the 67 TFLOP/s float32
peak: bound by bytes. Reading every stored block would take 0.290 ms; the
nonzero 32 x 16 slabs are 20% of them there.

``to_bsr`` and ``bsr_density`` are host numpy copies of the reference's,
exact for the same inputs; ``BsrLayout`` is one graph's layout on the
device, built once by ``ops.prepare_bsr``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build

# launches of the CUDA kernel (plain CPU calls do not count)
launches = 0

# (rows, features) of the CUDA block tiles of csrc/bsr_spmm.cu (``tile``)
WIDE_TILE = (32, 64)
NARROW_TILE = (16, 64)
# the wide tile when its grid gives every multiprocessor this many blocks
WIDE_MIN_BLOCKS_PER_SM = 16
# occupancy granule (rows and columns of a sub-block) and slab depth
GRAIN = 16
_MAX_GRID_Y = 65535
# the kernel lists a chunk's slabs in 1,024 shared-memory slots
_MAX_R = 1024 * GRAIN


@dataclasses.dataclass(frozen=True)
class BsrLayout:
    """One graph's BSR adjacency on a device: ``row_ptr [nbr + 1]`` int32
    (block row r owns blocks ``row_ptr[r] .. row_ptr[r+1]``), ``block_cols
    [nnzb]`` int32 and ``blocks [nnzb, R, R]`` float32, sorted by (row,
    col); ``occupancy`` its blocks' nonzero sub-blocks
    (:func:`slab_occupancy`); ``n_nodes`` real rows of the ``n_block_rows *
    R`` it covers."""
    row_ptr: torch.Tensor
    block_cols: torch.Tensor
    blocks: torch.Tensor
    occupancy: torch.Tensor
    n_block_rows: int
    n_nodes: int

    @property
    def block(self) -> int:
        return int(self.blocks.shape[1])


def to_bsr(n_nodes: int, senders: np.ndarray, receivers: np.ndarray,
           edge_weight: np.ndarray, block: int = 128):
    """Host-side BSR conversion (numpy). Returns
    (block_rows [nnzb], block_cols [nnzb], blocks [nnzb, R, R], n_block_rows).

    Every block row is guaranteed at least one block (zero-filled if empty).
    Arc (s, r, w) contributes w at dense position (s, r) — i.e. out[s] sums
    messages from its neighbors r, matching segment_sum over senders.
    """
    nb = (n_nodes + block - 1) // block
    br = senders // block
    bc = receivers // block
    key = br.astype(np.int64) * nb + bc
    uniq, inv = np.unique(key, return_inverse=True)
    # ensure every block row appears
    present = np.zeros(nb, dtype=bool)
    present[(uniq // nb).astype(np.int64)] = True
    missing = np.nonzero(~present)[0]
    all_keys = np.concatenate([uniq, missing * nb])  # diagonal zero blocks
    order = np.argsort(all_keys, kind="stable")
    all_keys = all_keys[order]
    remap = np.empty_like(order)
    remap[order] = np.arange(order.shape[0])
    blocks = np.zeros((all_keys.shape[0], block, block), dtype=np.float32)
    bid = remap[inv]
    np.add.at(blocks, (bid, senders % block, receivers % block), edge_weight)
    return (all_keys // nb).astype(np.int32), \
        (all_keys % nb).astype(np.int32), blocks, nb


def bsr_density(block_rows: np.ndarray, n_block_rows: int, n_block_cols: int):
    """Fraction of the dense block grid that is materialized — the locality
    metric the partitioner's reordering drives down."""
    return block_rows.shape[0] / float(n_block_rows * n_block_cols)


def row_pointers(block_rows: np.ndarray, n_block_rows: int) -> np.ndarray:
    """``[nbr + 1]`` int32 offsets of each block row's run in the sorted
    ``block_rows``."""
    ptr = np.zeros(n_block_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(block_rows, minlength=n_block_rows), out=ptr[1:])
    return ptr.astype(np.int32)


def slab_occupancy(blocks: torch.Tensor) -> torch.Tensor:
    """``[nnzb, S, W]`` int32, ``S = ceil(R / 16)``, ``W = ceil(S / 32)``:
    bit ``j % 32`` of word ``j // 32`` of ``occ[t, s]`` is set iff block t
    has a nonzero in rows ``16s .. 16s+15`` and columns ``16j .. 16j+15``
    (on the blocks' device; what the kernel skips by)."""
    nnzb, r, _ = blocks.shape
    s = -(-r // GRAIN)
    w = -(-s // 32)
    pad = s * GRAIN - r
    nz = blocks != 0
    if pad:
        nz = torch.nn.functional.pad(nz, (0, pad, 0, pad))
    sub = nz.view(nnzb, s, GRAIN, s, GRAIN).any(4).any(2)   # [nnzb, s, s]
    sub = torch.nn.functional.pad(sub, (0, w * 32 - s)).view(nnzb, s, w, 32)
    bits = 2.0 ** torch.arange(32, dtype=torch.float64, device=blocks.device)
    words = (sub.double() * bits).sum(-1).long()   # exact: < 2**32
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def nonzero_slabs(occupancy: torch.Tensor, rows: int) -> Tuple[int, int]:
    """(slabs read, slabs stored): the 16-column slabs of the blocks that a
    row tile of ``rows`` (a multiple of 16) reads, those with a nonzero in
    any of its strips, against all ``nnzb * row tiles * S`` of them."""
    nnzb, s, w = occupancy.shape
    per = rows // GRAIN
    tiles = -(-s // per)
    occ = torch.nn.functional.pad(occupancy, (0, 0, 0, tiles * per - s))
    merged = occ.view(nnzb, tiles, per, w)
    acc = torch.zeros(nnzb, tiles, w, dtype=torch.int64,
                      device=occupancy.device)
    for i in range(per):                    # OR over the tile's strips
        acc |= merged[:, :, i].long() & 0xFFFFFFFF
    read = sum(int(((acc >> b) & 1).sum()) for b in range(32))
    return read, nnzb * tiles * s


def tile(n_block_rows: int, r: int, f: int,
         sms: int) -> Tuple[int, int]:
    """The kernel's (rows, features) tile: ``WIDE_TILE`` when R is at least
    its height and its grid gives each of the card's ``sms``
    multiprocessors ``WIDE_MIN_BLOCKS_PER_SM`` blocks, where its reuse of
    each ``x`` slab over more rows pays; else ``NARROW_TILE``, whose
    shorter row tiles read fewer all-zero slabs and make twice the grid.
    (On one H100: 177 against 184 us at the bulk molecule layout, 111
    against 137 us at the placed rmat graph's 98 block rows.)"""
    bm, bn = WIDE_TILE
    ctas = n_block_rows * -(-r // bm) * -(-f // bn)
    wide = r >= bm and ctas >= WIDE_MIN_BLOCKS_PER_SM * sms
    return WIDE_TILE if wide else NARROW_TILE


def plain(row_ptr: torch.Tensor, block_cols: torch.Tensor,
          blocks: torch.Tensor, x: torch.Tensor,
          chunk: int = 4096) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path): per chunk of
    blocks, ``bmm`` with the gathered ``x`` tiles, then ``index_add_`` into
    the output block rows. (The reference's ``bsr_spmm_ref`` scatters into a
    dense ``[n, n]`` matrix, which no real batch fits.)"""
    nnzb, r, _ = blocks.shape
    nbr = row_ptr.shape[0] - 1
    f = x.shape[1]
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(nbr, device=x.device), counts, output_size=nnzb)
    x_tiles = x.reshape(-1, r, f)
    out = torch.zeros(nbr, r, f, dtype=x.dtype, device=x.device)
    for i in range(0, nnzb, chunk):
        prod = torch.bmm(blocks[i:i + chunk],
                         x_tiles[block_cols[i:i + chunk].long()])
        out.index_add_(0, rows[i:i + chunk], prod)
    return out.view(nbr * r, f)


def order_tolerance(row_ptr: torch.Tensor, block_cols: torch.Tensor,
                    blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[nbr * R, F]`` bound on the difference between two float32 sums of
    the same products taken in different orders (the kernel's fmaf chain,
    ``bmm`` + ``index_add_``): ``2 * K * 2**-24 * (|A| @ |x|)`` with K the
    most terms of one output, R times the most blocks in a block row."""
    k = blocks.shape[1] * int((row_ptr[1:] - row_ptr[:-1]).max())
    return (2.0 * k * 2.0 ** -24) * plain(row_ptr, block_cols, blocks.abs(),
                                          x.abs())


def bsr_spmm(row_ptr: torch.Tensor, block_cols: torch.Tensor,
             blocks: torch.Tensor, x: torch.Tensor,
             occupancy: torch.Tensor) -> torch.Tensor:
    """``out [nbr * R, F] = BSR(A) @ x`` for ``x [n_block_cols * R, F]``
    float32 and the layout arrays of :class:`BsrLayout`, ``occupancy`` its
    :func:`slab_occupancy`: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors. Block columns must lie below ``n_block_cols``
    and ``row_ptr`` must rise from 0 to ``nnzb`` (``ops.prepare_bsr``
    builds them so; the kernel does not check)."""
    global launches
    dev = x.device
    if dev.type == "cpu":
        return plain(row_ptr, block_cols, blocks, x)
    if dev.type != "cuda":
        raise ValueError(f"bsr_spmm: no kernel for device {dev}")
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"bsr_spmm: blocks must be [nnzb, R, R], got "
                         f"{tuple(blocks.shape)}")
    nnzb, r, _ = blocks.shape
    if r == 0 or x.dim() != 2 or x.shape[0] % r:
        raise ValueError(f"bsr_spmm: x must be [n_block_cols * {r}, F], got "
                         f"{tuple(x.shape)}")
    if r > _MAX_R:
        raise ValueError(f"bsr_spmm: blocks of {r} rows, at most {_MAX_R}")
    nbr, f = row_ptr.shape[0] - 1, x.shape[1]
    build.require(row_ptr, "bsr_spmm row_ptr", torch.int32, dev, (nbr + 1,))
    build.require(block_cols, "bsr_spmm block_cols", torch.int32, dev,
                  (nnzb,))
    build.require(blocks, "bsr_spmm blocks", torch.float32, dev, (nnzb, r, r))
    build.require(x, "bsr_spmm x", torch.float32, dev, tuple(x.shape))
    s = -(-r // GRAIN)
    build.require(occupancy, "bsr_spmm occupancy", torch.int32, dev,
                  (nnzb, s, -(-s // 32)))
    shape = tile(nbr, r, f, build.sm_count(dev))
    bm, bn = shape
    if -(-f // bn) > _MAX_GRID_Y or nbr * -(-r // bm) >= 2 ** 31:
        raise ValueError(f"bsr_spmm: grid too large for F = {f}, "
                         f"{nbr} block rows of {r}")
    out = torch.empty(nbr * r, f, dtype=torch.float32, device=dev)
    if nbr == 0 or f == 0:
        return out
    vec = int(r % 4 == 0 and f % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (blocks, x, out)))
    fn = build.entry("bsr_spmm", [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p])
    build.check("bsr_spmm", fn(
        build.ptr(row_ptr), build.ptr(block_cols), build.ptr(occupancy),
        build.ptr(blocks), build.ptr(x), build.ptr(out), nbr, r, f,
        int(shape == WIDE_TILE), vec, build.stream_of(dev)))
    launches += 1
    return out
