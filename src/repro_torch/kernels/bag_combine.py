"""Weighted bag reduction over pre-gathered rows (``ops.embedding_bag``).

Replaces the Pallas kernel ``repro/kernels/bag_combine.py:bag_combine`` with
``csrc/bag_combine.cu``:

    out[b, f] = sum over slots d of w[b, d] * g[b, d, f]

The TPU kernel is a batched vec-mat on the matrix unit over (bag tile,
feature tile). At ~0.5 flop per byte it is a streaming reduction on
Hopper, bound by reading ``g`` once: one block row per bag, 16-byte loads
across F (one warp per block over 32 columns where the grid cannot fill
the card, as for one retrieve query), the slots summed in order in
registers with separately rounded products and sums
(``csrc/bag_reduce.cuh``, shared with ``gather_combine``, so
``embedding_bag`` and the fused lookup agree bitwise). Mean-combine is the
caller's ``w = 1 / bag_len``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gather_combine import vec_width

# launches of the CUDA kernel (plain CPU calls do not count)
launches = 0


def plain(gathered: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path), as
    ``repro/kernels/ref.py:bag_combine_ref``."""
    return torch.einsum("bdf,bd->bf", gathered, weights.to(gathered.dtype))


def order_tolerance(gathered: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """``[B, F]`` bound on the difference between two float32 sums of the
    same D products taken in different orders (the kernels' slot order,
    einsum's blocked one): ``2 * D * 2**-24 * sum_d |w[b, d] * g[b, d, f]|``.
    """
    d = gathered.shape[1]
    return (2.0 * d * 2.0 ** -24) * torch.einsum(
        "bdf,bd->bf", gathered.abs().double(), weights.abs().double())


def bag_combine(gathered: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``[B, D, F]`` float32 x ``[B, D]`` float32 -> ``[B, F]``: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    global launches
    dev = gathered.device
    if dev.type == "cpu":
        return plain(gathered, weights)
    if dev.type != "cuda":
        raise ValueError(f"bag_combine: no kernel for device {dev}")
    if gathered.dim() != 3:
        raise ValueError(f"bag_combine: gathered must be [B, D, F], got "
                         f"{tuple(gathered.shape)}")
    b, d, f = gathered.shape
    build.require(gathered, "bag_combine gathered", torch.float32, dev,
                  (b, d, f))
    build.require(weights, "bag_combine weights", torch.float32, dev, (b, d))
    out = torch.empty((b, f), dtype=torch.float32, device=dev)
    if b == 0 or f == 0:
        return out
    fn = build.entry("bag_combine", [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    build.check("bag_combine", fn(
        build.ptr(gathered), build.ptr(weights), build.ptr(out), b, d, f,
        vec_width(gathered, out), build.sm_count(dev),
        build.stream_of(dev)))
    launches += 1
    return out
