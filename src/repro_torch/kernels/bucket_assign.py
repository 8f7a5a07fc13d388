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
Both launches come from plans (:func:`plan`, :func:`split_plan`;
``kernels/plan.py``).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import plan as plan_lib

launches = 0
# launches of prefix_split (plain CPU calls do not count)
split_launches = 0
# boundaries live in one block's shared memory (48 KB without opt-in)
MAX_BOUNDARIES = 48 * 1024 // 4
# prefix_split's boundaries share the 48 KB with its scan's few words
MAX_SPLIT_BOUNDARIES = (48 * 1024 - 256) // 4
# vertices of one prefix_split tile (1,024 threads x 16): a call over at
# most this many runs as one block, a larger one as a cooperative launch
SPLIT_THREADS = 1024
SPLIT_ITEMS = 16
SPLIT_TILE = SPLIT_THREADS * SPLIT_ITEMS
# the map: 256 threads a block, at most 8 blocks an SM (grid-stride)
MAP_THREADS = 256
MAP_BLOCKS_PER_SM = 8

# prefix_split's cooperative workspace by device: two barrier words, zero
# between calls, then one float per tile
_split_work: Dict[torch.device, torch.Tensor] = {}
# pinned staging of prefix_split_host's weights and boundaries by device
_staging: Dict[torch.device, torch.Tensor] = {}


def plain(cum: torch.Tensor, boundaries: torch.Tensor, k: int) -> torch.Tensor:
    """The same count in plain PyTorch (``[n, k-1]`` comparisons)."""
    count = (cum[:, None] >= boundaries[None, :]).sum(dim=1)
    return count.clamp(0, k - 1).to(torch.int32)


_plans = plan_lib.cache("bucket_assign")


def plan(n: int, nb: int, device=None) -> plan_lib.LaunchPlan:
    """The map's launch over ``n`` midpoints and ``nb`` boundaries, cached
    by shape: a thread a vertex, grid-stride, the boundaries in shared
    memory."""
    return _plans.get_or_build(("map", n, nb, device), lambda: _map_plan(
        n, nb, plan_lib.device_model(device)))


def _map_plan(n, nb, model):
    blocks = max(1, min(-(-n // MAP_THREADS), model.sms * MAP_BLOCKS_PER_SM))

    def verts(clip):
        return lambda b: plan_lib.strided(b, MAP_THREADS, blocks, n, clip)

    arg = plan_lib.Arg
    return plan_lib.LaunchPlan(
        name="bucket_assign", entry="bucket_assign",
        kernel="bucket_assign_kernel", grid=(blocks,),
        threads=(MAP_THREADS,), dyn_smem=4 * max(nb, 1),
        operands=(arg("cum", (n,), "float32"),
                  arg("boundaries", (nb,), "float32")),
        outputs=(arg("bin", (n,), "int32"),),
        writes=(verts(False),),
        reads=(verts(True), lambda b: [((0, nb),)]),
        masked_edges=((True,),))


def split_plan(n: int, nb: int, device=None) -> plan_lib.LaunchPlan:
    """``prefix_split``'s launch over ``n`` vertices and ``nb`` boundaries,
    cached by shape: up to one tile (``SPLIT_TILE`` vertices) one block of
    as many warps as the vertices need, beyond that one cooperative launch
    of a block a tile, cut to the blocks the card holds at once."""
    return _plans.get_or_build(("split", n, nb, device), lambda: _split_plan(
        n, nb, device))


def _split_plan(n, nb, device):
    model = plan_lib.device_model(device)
    coop = n > SPLIT_TILE
    if coop:
        threads = SPLIT_THREADS
    else:
        threads = max(32, -(-(-(-n // SPLIT_ITEMS)) // 32) * 32)
    smem = threads * SPLIT_ITEMS * 4 + 4 * max(nb, 1)
    kernel = f"prefix_split_kernel<{'true' if coop else 'false'}>"
    tile = threads * SPLIT_ITEMS
    tiles = max(1, -(-n // tile))
    blocks = 1
    if coop:
        per_sm = plan_lib.occupancy("prefix_split", kernel, threads, smem, 1,
                                    device)
        blocks = min(tiles, max(per_sm, 1) * model.sms)

    def tiles_of(b, clip):
        return plan_lib.strided(b, tile, blocks, n, clip)

    arg = plan_lib.Arg
    phase = 1 if coop else 0
    return plan_lib.LaunchPlan(
        name="bucket_assign", entry="prefix_split", kernel=kernel,
        grid=(blocks,), threads=(threads,), dyn_smem=smem,
        smem_optin=smem > 48 * 1024, cooperative=coop,
        operands=(arg("node_weight", (n,), "float32"),
                  arg("boundaries", (nb,), "float32"),
                  arg("work", (max(tiles, 256) + 2,), "int32")),
        outputs=(arg("bin", (n,), "int32"),),
        writes=(lambda b: [plan_lib.Tile(t, phase)
                           for t in tiles_of(b, False)],),
        reads=(lambda b: tiles_of(b, True), lambda b: [((0, nb),)],
               plan_lib.INDIRECT),
        masked_edges=((True,),), phases=2 if coop else 1,
        args={"path": "cooperative" if coop else "one_block"})


def example_plans():
    """The reference's example (``n=4096, k=64``), and ``prefix_split`` as
    one block (the full cell's coarsest 12,288 vertices) and cooperative
    past 16,384 vertices (one million)."""
    return [plan(4096, 63), split_plan(12_288, 511),
            split_plan(1_000_000, 63)]


def launch(p: plan_lib.LaunchPlan, cum, boundaries, out, k: int,
           stream=None) -> None:
    """One launch of the map's plan ``p``."""
    fn = build.entry("bucket_assign", [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        + build.LAUNCH_ARGTYPES)
    build.check("bucket_assign", fn(
        build.ptr(cum), build.ptr(boundaries), build.ptr(out), cum.shape[0],
        boundaries.shape[0], k, *p.launch_dims(),
        build.stream_of(cum.device) if stream is None else stream))


def launch_split(p: plan_lib.LaunchPlan, node_weight, boundaries, out, work,
                 k: int, stream=None) -> None:
    """One launch of the split's plan ``p``."""
    fn = build.entry("prefix_split", [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong] + [ctypes.c_int] * 3 + build.LAUNCH_ARGTYPES)
    build.check("prefix_split", fn(
        build.ptr(node_weight), build.ptr(boundaries), build.ptr(out),
        build.ptr(work), node_weight.shape[0], boundaries.shape[0], k,
        int(p.cooperative), *p.launch_dims(),
        build.stream_of(node_weight.device) if stream is None else stream))


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
    p = plan(n, nb, cum.device)
    out = torch.empty(n, dtype=torch.int32, device=cum.device)
    launch(p, cum, boundaries, out, k)
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
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    p = split_plan(n, nb, dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    work = (_split_workspace(dev, -(-n // SPLIT_TILE)) if p.cooperative
            else out)   # the one-block path reads no workspace
    launch_split(p, node_weight, boundaries, out, work, k)
    split_launches += 1
    return out


def split_blocks(n: int, nb: int, dev: torch.device) -> int:
    """The blocks a ``prefix_split`` launch over ``n`` vertices takes on
    ``dev``'s card: 1 for the one-block path, else the cooperative grid
    (its plan's)."""
    return split_plan(n, nb, dev).blocks


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
