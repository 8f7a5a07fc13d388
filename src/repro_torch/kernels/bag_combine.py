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

Rows and weights are float32, or both bf16 as the reference takes the
input's dtype (``repro/kernels/bag_combine.py``): the kernel widens bf16
rows and weights as it reads them, sums in float32 and rounds once to
bf16, as ``gather_combine``'s bf16 path does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gather_combine import DTYPES

# launches of the CUDA kernel (plain CPU calls do not count)
launches = 0


def plain(gathered: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path), as
    ``repro/kernels/ref.py:bag_combine_ref``; bf16 inputs are summed in
    float32 and the sum rounded once to bf16, as the kernel does."""
    if gathered.dtype == torch.bfloat16:
        return torch.einsum("bdf,bd->bf", gathered.float(),
                            weights.float()).to(torch.bfloat16)
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


def _vec(gathered: torch.Tensor, out: torch.Tensor) -> int:
    """Elements per 16-byte column where both tensors' rows are whole
    16-byte columns on aligned bases (4 float32, 8 bf16), else 1."""
    per = 16 // DTYPES[gathered.dtype]
    ok = all(t.shape[-1] % per == 0 and t.data_ptr() % 16 == 0
             for t in (gathered, out))
    return per if ok else 1


def bag_combine(gathered: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``[B, D, F]`` x ``[B, D]`` -> ``[B, F]``, float32 or bf16 (the
    weights of the rows' dtype, the output too): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
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
    if gathered.dtype not in DTYPES:
        raise TypeError(f"bag_combine gathered: dtype {gathered.dtype}, "
                        f"expected one of {list(DTYPES)}")
    build.require(gathered, "bag_combine gathered", gathered.dtype, dev,
                  (b, d, f))
    build.require(weights, "bag_combine weights", gathered.dtype, dev, (b, d))
    out = torch.empty((b, f), dtype=gathered.dtype, device=dev)
    if b == 0 or f == 0:
        return out
    fn = build.entry("bag_combine", [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    build.check("bag_combine", fn(
        build.ptr(gathered), build.ptr(weights), build.ptr(out), b, d, f,
        _vec(gathered, out), DTYPES[gathered.dtype], build.sm_count(dev),
        build.stream_of(dev)))
    launches += 1
    return out
