"""Capacity-boundary bucket assignment for the device initial partition.

Replaces the Pallas kernel
``repro/kernels/bucket_assign.py:bucket_assign_tiled`` with
``csrc/bucket_assign.cu``. Vertex ``v`` with weight midpoint ``cum[v]``
lands in

    bin[v] = min(#{ i < k-1 : cum[v] >= boundary[i] }, k-1)

The kernel keeps the k-1 boundaries in shared memory and counts crossings
exactly as the TPU kernel does (no binary search, so no order is assumed);
at the partitioner's sizes (n ~ 1e4 coarsest vertices) it is bound by launch
latency, not by its 8 B per vertex. The clip to [0, k-1] is fused into its
store.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0
# boundaries live in one block's shared memory (48 KB without opt-in)
MAX_BOUNDARIES = 48 * 1024 // 4


def plain(cum: torch.Tensor, boundaries: torch.Tensor, k: int) -> torch.Tensor:
    """The same count in plain PyTorch (``[n, k-1]`` comparisons)."""
    count = (cum[:, None] >= boundaries[None, :]).sum(dim=1)
    return count.clamp(0, k - 1).to(torch.int32)


def bucket_assign(cum: torch.Tensor, boundaries: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Bin ``[n]`` int32 in [0, k-1] of every midpoint: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    global launches
    if cum.device.type == "cpu":
        return plain(cum, boundaries, k)
    if cum.device.type != "cuda":
        raise ValueError(f"bucket_assign: no kernel for device {cum.device}")
    n, nb = cum.shape[0], boundaries.shape[0]
    build.require(cum, "bucket_assign cum", torch.float32, cum.device, (n,))
    build.require(boundaries, "bucket_assign boundaries", torch.float32,
                  cum.device, (nb,))
    if nb > MAX_BOUNDARIES:
        raise ValueError(f"bucket_assign: {nb} boundaries exceed the "
                         f"shared-memory tile of {MAX_BOUNDARIES}")
    if k < 1:
        raise ValueError(f"bucket_assign: k must be >= 1, got {k}")
    out = torch.empty(n, dtype=torch.int32, device=cum.device)
    fn = build.entry("bucket_assign", [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    build.check("bucket_assign", fn(
        build.ptr(cum), build.ptr(boundaries), build.ptr(out), n, nb, k,
        build.sm_count(cum.device), build.stream_of(cum.device)))
    launches += 1
    return out
