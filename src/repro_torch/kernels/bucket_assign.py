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
store. No path runs it: ``initial_partition_device`` runs the whole split
as ``prefix_split``.

``prefix_split`` is the capacity-prefix split of the device initial
partition in one launch (``prefix_split_kernel`` in the same source): from
the node weights ``w`` and the k-1 non-decreasing boundaries,

    cum[v] = (w[0] + ... + w[v]) - w[v] / 2
    bin[v] = min(#{ i : cum[v] >= boundary[i] }, k-1)

the scan, the midpoints, the count (a binary search over the boundaries in
shared memory, which needs them sorted: their order is checked on the host,
and unsorted boundaries raise) and the clip. The scan sums in an order
fixed by n, so two calls give bitwise the same bins; integer weights below
2**24 in all are exact in any order, so there the bins equal the plain
version's. :func:`prefix_split_host` is the entry of
``initial_partition_device``: one pinned host-to-device copy of the
weights and the boundaries, the launch, and the copy of the bins back.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import build

launches = 0
# launches of prefix_split (plain CPU calls do not count)
split_launches = 0
# boundaries live in one block's shared memory (48 KB without opt-in)
MAX_BOUNDARIES = 48 * 1024 // 4
# prefix_split's boundaries share the 48 KB with its scan's few words
MAX_SPLIT_BOUNDARIES = (48 * 1024 - 256) // 4
# vertices of one prefix_split tile (1,024 threads x 16): a call over at
# most this many runs as one block, a larger one as a cooperative launch
SPLIT_TILE = 1024 * 16

# prefix_split's cooperative workspace by device: two barrier words, zero
# between calls, then one float per tile
_split_work: Dict[torch.device, torch.Tensor] = {}
# pinned staging of prefix_split_host's weights and boundaries by device
_staging: Dict[torch.device, torch.Tensor] = {}


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


def check_boundaries(boundaries) -> None:
    """Raise unless the boundaries (host values: a numpy array or a CPU
    tensor) are non-decreasing, as ``prefix_split``'s binary search needs
    (a cumsum of positive capacities is)."""
    b = np.asarray(boundaries, dtype=np.float64)
    if b.size > 1 and not bool((b[1:] >= b[:-1]).all()):
        raise ValueError("prefix_split: boundaries must be non-decreasing")


def prefix_split_plain(node_weight: torch.Tensor, boundaries: torch.Tensor,
                       k: int) -> torch.Tensor:
    """The split in plain PyTorch: the float32 ``torch.cumsum`` midpoints
    (``repro/core/initial.py``), then :func:`plain`."""
    cum = torch.cumsum(node_weight, dim=0) - 0.5 * node_weight
    return plain(cum, boundaries, k)


def _split_workspace(dev: torch.device, tiles: int) -> torch.Tensor:
    """The barrier words and room for ``tiles`` tile totals on ``dev``."""
    buf = _split_work.get(dev)
    if buf is None or buf.numel() < tiles + 2:
        buf = torch.zeros(max(tiles, 256) + 2, dtype=torch.int32, device=dev)
        _split_work[dev] = buf
    return buf


def split_kernel(node_weight: torch.Tensor, boundaries: torch.Tensor,
                 k: int) -> torch.Tensor:
    """The ``prefix_split`` launch alone, on CUDA tensors whose boundaries
    the caller has checked (:func:`check_boundaries`): ``[n]`` int32."""
    global split_launches
    dev = node_weight.device
    if dev.type != "cuda":
        raise ValueError(f"prefix_split: no kernel for device {dev}")
    n, nb = node_weight.shape[0], boundaries.shape[0]
    build.require(node_weight, "prefix_split node_weight", torch.float32,
                  dev, (n,))
    build.require(boundaries, "prefix_split boundaries", torch.float32, dev,
                  (nb,))
    if nb > MAX_SPLIT_BOUNDARIES:
        raise ValueError(f"prefix_split: {nb} boundaries exceed the "
                         f"shared-memory tile of {MAX_SPLIT_BOUNDARIES}")
    if k < 1:
        raise ValueError(f"prefix_split: k must be >= 1, got {k}")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    work = (_split_workspace(dev, -(-n // SPLIT_TILE)) if n > SPLIT_TILE
            else out)   # the one-block path reads no workspace
    fn = build.entry("prefix_split", [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    build.check("prefix_split", fn(
        build.ptr(node_weight), build.ptr(boundaries), build.ptr(out),
        build.ptr(work), n, nb, k, build.sm_count(dev),
        build.stream_of(dev)))
    split_launches += 1
    return out


def split_blocks(n: int, nb: int, dev: torch.device) -> int:
    """The blocks a ``prefix_split`` launch over ``n`` vertices takes on
    ``dev``'s card: 1 for the one-block path, else the cooperative grid."""
    fn = build.library().prefix_split_blocks
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return int(fn(n, nb, build.sm_count(dev)))


def prefix_split(node_weight: torch.Tensor, boundaries: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Bin ``[n]`` int32 in [0, k-1] of every vertex from its float32
    weight ``[n]`` and the k-1 non-decreasing float32 boundaries: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors. The order
    is checked on the host (for CUDA boundaries by reading the k-1 values
    back) and unsorted boundaries raise."""
    dev = node_weight.device
    if dev.type == "cpu":
        check_boundaries(boundaries)
        return prefix_split_plain(node_weight, boundaries, k)
    if dev.type != "cuda":
        raise ValueError(f"prefix_split: no kernel for device {dev}")
    check_boundaries(boundaries.cpu())
    return split_kernel(node_weight, boundaries, k)


def prefix_split_host(node_weight: np.ndarray, boundaries: np.ndarray,
                      k: int, device: torch.device) -> np.ndarray:
    """:func:`prefix_split` of host arrays on ``device``: the order checked
    here; on a card, the float32 weights and boundaries staged in one pinned
    buffer and sent in one copy, one launch, and the bins copied back.
    ``[n]`` int32 numpy."""
    nw = np.asarray(node_weight, dtype=np.float32)
    b = np.asarray(boundaries, dtype=np.float32)
    check_boundaries(b)
    if device.type == "cpu":
        return prefix_split_plain(torch.from_numpy(nw), torch.from_numpy(b),
                                  k).numpy()
    n, nb = nw.shape[0], b.shape[0]
    stage = _staging.get(device)
    if stage is None or stage.numel() < n + nb:
        stage = torch.empty(max(n + nb, 1 << 14), dtype=torch.float32,
                            pin_memory=True)
        _staging[device] = stage
    host = stage.numpy()
    host[:n] = nw
    host[n:n + nb] = b
    # the previous call's copy has finished: its bins were copied back
    buf = stage[:n + nb].to(device, non_blocking=True)
    return split_kernel(buf[:n], buf[n:], k).cpu().numpy()
