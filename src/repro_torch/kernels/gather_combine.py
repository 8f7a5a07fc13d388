"""Fused embedding-bag gather + combine (``ShardedEmbeddingTable.lookup_bags``).

Replaces the Pallas kernel ``repro/kernels/gather_combine.py:gather_combine``
with ``csrc/gather_combine.cu``:

    out[b, f] = sum over slots d of w[b, d] * table[idx[b, d], f]

without materialising the ``[B, D, F]`` gathered rows. The TPU kernel
scalar-prefetches the ids and DMAs one row tile per sequential grid step;
on Hopper a block loads its own bags' ids and weights into shared memory
and its threads read each named row in 16-byte loads across F, summing the
slots in order in registers (``csrc/bag_reduce.cuh``, shared with
``bag_combine``, so the two agree bitwise); a grid too small to fill the
card spreads F over one warp per block and reads the ids and weights
without staging. Bound by device-memory bytes:
the rows the bags name, their ids and weights, and the output. Ids must lie
in ``[0, V)``: callers map padding to row 0 with weight 0, as the reference
does, since torch's indexing raises where JAX's clamps.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches of the CUDA kernel (plain CPU calls do not count)
launches = 0


def plain(table: torch.Tensor, idx: torch.Tensor,
          weights: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path): the gather, then
    ``einsum("bdf,bd->bf")``, as ``repro/kernels/ref.py``."""
    return torch.einsum("bdf,bd->bf", table[idx], weights.to(table.dtype))


def vec_width(*tensors: torch.Tensor) -> int:
    """4 (float4 rows) when every tensor's rows are 16-byte aligned, else 1."""
    ok = all(t.shape[-1] % 4 == 0 and t.data_ptr() % 16 == 0
             for t in tensors)
    return 4 if ok else 1


def gather_combine(table: torch.Tensor, idx: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """``[V, F]`` float32 table, ``[B, D]`` int32 row ids, ``[B, D]`` float32
    weights -> ``[B, F]``: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    global launches
    dev = table.device
    if dev.type == "cpu":
        return plain(table, idx, weights)
    if dev.type != "cuda":
        raise ValueError(f"gather_combine: no kernel for device {dev}")
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"gather_combine: table [V, F] and idx [B, D], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    (v, f), (b, d) = table.shape, idx.shape
    build.require(table, "gather_combine table", torch.float32, dev, (v, f))
    build.require(idx, "gather_combine idx", torch.int32, dev, (b, d))
    build.require(weights, "gather_combine weights", torch.float32, dev,
                  (b, d))
    out = torch.empty((b, f), dtype=torch.float32, device=dev)
    if b == 0 or f == 0:
        return out
    fn = build.entry("gather_combine", [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    build.check("gather_combine", fn(
        build.ptr(table), build.ptr(idx), build.ptr(weights), build.ptr(out),
        b, d, f, vec_width(table, out), build.sm_count(dev),
        build.stream_of(dev)))
    launches += 1
    return out
