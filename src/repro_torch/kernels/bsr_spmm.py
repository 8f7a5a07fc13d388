"""Block-sparse SpMM over BSR blocks (GIN's sum aggregation ``A @ X``).

Replaces the Pallas kernel ``repro/kernels/bsr_spmm.py:bsr_spmm`` with
``csrc/bsr_spmm.cu``:

    out[r*R:(r+1)*R, f] = sum over the nonzero blocks t of block row r of
                          A_t @ x[cols[t]*R:(cols[t]+1)*R, f]

The TPU kernel walks the blocks as a sequential grid axis into a resident
output tile; Hopper has no ordered grid, so one CUDA block per (block row,
row tile, feature tile) walks ``row_ptr[r] .. row_ptr[r+1]`` itself,
stages slabs of ``A_t`` and of the ``x`` tile in shared memory and
accumulates in registers in full float32 FMAs (TF32 stays off, as the
reference computes in f32). Each output is written once, in a fixed order:
no atomics, deterministic.

Bound on the H100 at GIN-TU's bulk batch (3,840 block rows, 11,008 blocks
of 128 x 128, F = 64): 0.290 ms for the 973 MB of blocks, ``x`` and
``out`` at 3.35 TB/s, against 0.004 ms for the product's 0.25 GFLOP (one
multiply-add per nonzero and feature) at the 67 TFLOP/s float32 peak:
bound by bytes. The kernel does every block's dense product, 23.1 GFLOP
(0.345 ms at that peak); the blocks of a molecule batch are ~1% nonzero,
and skipping their all-zero slabs is later speed work.

``to_bsr`` and ``bsr_density`` are host numpy copies of the reference's,
exact for the same inputs; ``BsrLayout`` is one graph's layout on the
device, built once by ``ops.prepare_bsr``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import build

# launches of the CUDA kernel (plain CPU calls do not count)
launches = 0

# (rows, features) of the two CUDA block tiles of csrc/bsr_spmm.cu
WIDE_TILE = (128, 64)
NARROW_TILE = (32, 32)
_MAX_GRID_Y = 65535


@dataclasses.dataclass(frozen=True)
class BsrLayout:
    """One graph's BSR adjacency on a device: ``row_ptr [nbr + 1]`` int32
    (block row r owns blocks ``row_ptr[r] .. row_ptr[r+1]``), ``block_cols
    [nnzb]`` int32 and ``blocks [nnzb, R, R]`` float32, sorted by (row,
    col); ``n_nodes`` real rows of the ``n_block_rows * R`` it covers."""
    row_ptr: torch.Tensor
    block_cols: torch.Tensor
    blocks: torch.Tensor
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


def wide_tile(n_block_rows: int, r: int, f: int, sms: int) -> bool:
    """The 128 x 64 tile when R is at least its height and its grid alone
    fills the card's ``sms`` multiprocessors; else the 32 x 32 tile."""
    bm, bn = WIDE_TILE
    ctas = n_block_rows * -(-r // bm) * -(-f // bn)
    return r >= bm and ctas >= sms


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
             blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out [nbr * R, F] = BSR(A) @ x`` for ``x [n_block_cols * R, F]``
    float32 and the layout arrays of :class:`BsrLayout`: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors. Block columns must
    lie below ``n_block_cols`` and ``row_ptr`` must rise from 0 to ``nnzb``
    (``ops.prepare_bsr`` builds them so; the kernel does not check)."""
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
    nbr, f = row_ptr.shape[0] - 1, x.shape[1]
    build.require(row_ptr, "bsr_spmm row_ptr", torch.int32, dev, (nbr + 1,))
    build.require(block_cols, "bsr_spmm block_cols", torch.int32, dev,
                  (nnzb,))
    build.require(blocks, "bsr_spmm blocks", torch.float32, dev, (nnzb, r, r))
    build.require(x, "bsr_spmm x", torch.float32, dev, tuple(x.shape))
    wide = wide_tile(nbr, r, f, build.sm_count(dev))
    bm, bn = WIDE_TILE if wide else NARROW_TILE
    if -(-f // bn) > _MAX_GRID_Y or nbr * -(-r // bm) >= 2 ** 31:
        raise ValueError(f"bsr_spmm: grid too large for F = {f}, "
                         f"{nbr} block rows of {r}")
    out = torch.empty(nbr * r, f, dtype=torch.float32, device=dev)
    if nbr == 0 or f == 0:
        return out
    fn = build.entry("bsr_spmm", [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    build.check("bsr_spmm", fn(
        build.ptr(row_ptr), build.ptr(block_cols), build.ptr(blocks),
        build.ptr(x), build.ptr(out), nbr, r, f, int(wide),
        build.stream_of(dev)))
    launches += 1
    return out
