"""Connectivity rows for dense bottleneck refinement (ELL layout).

Replaces the Pallas kernel ``repro/kernels/partition_gain.py:
partition_gain_ell`` (with the ``part[nbr_idx]`` gather of
``repro/kernels/ops.py:partition_gain_pallas`` fused in) by
``csrc/partition_gain.cu``:

    conn[v, j] = sum over slots d of nbr_w[v, d] * [part[nbr_idx[v, d]] = j]

Padding slots hold the sentinel neighbour id ``n`` and weight 0. One CUDA
block owns a tile of rows (:func:`tile`): it stages the tile's slots and
their neighbours' bins in shared memory with coalesced loads, then one
thread per (row, bin) sums the row's matching slots in slot order from +0,
so every entry is the in-order float32 sum, bitwise; conn is written once,
coalesced. Bound: ``n*D*8 + n*4 + n*k*4`` bytes over device memory.
The launch comes from :func:`plan` (``kernels/plan.py``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plan as plan_lib

launches = 0
MAX_ROWS = 64                 # rows of a tile
MAX_THREADS = 256
STAGE_BYTES = 48 * 1024       # shared memory for a tile's staged slots


class PgTile(NamedTuple):
    rows: int                 # rows per block
    d_chunk: int              # slots of a row staged at once
    threads: int              # threads per block


def tile(n: int, d: int, k: int, n_sm: int) -> PgTile:
    """The tile for ``n`` rows of ``d`` slots and ``k`` bins on a card with
    ``n_sm`` SMs: as many rows as spread ``n`` over every SM (at most
    ``MAX_ROWS``), a thread per (row, bin) up to ``MAX_THREADS`` (a whole
    number of warps), and as many slots per row as fit ``STAGE_BYTES`` at
    8 B a slot."""
    rows = max(1, min(MAX_ROWS, -(-n // max(n_sm, 1))))
    threads = min(MAX_THREADS, max(32, -(-(rows * k) // 32) * 32))
    d_chunk = max(1, min(d, STAGE_BYTES // (8 * rows)))
    return PgTile(rows, d_chunk, threads)


def plain(part: torch.Tensor, nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
          k: int) -> torch.Tensor:
    """The same function in plain PyTorch: one ``index_add_`` over the
    flattened ``(row, bin)`` slots, padding routed to an extra column."""
    n, d = nbr_idx.shape
    part_pad = torch.cat([part.to(torch.int64),
                          torch.full((1,), k, dtype=torch.int64,
                                     device=part.device)])
    bins = part_pad[nbr_idx.long()]                       # [n, D], k = pad
    rows = torch.arange(n, device=part.device).repeat_interleave(d)
    conn = torch.zeros(n * (k + 1), dtype=torch.float32, device=part.device)
    conn.index_add_(0, rows * (k + 1) + bins.reshape(-1),
                    nbr_w.reshape(-1).to(torch.float32))
    return conn.view(n, k + 1)[:, :k]


_plans = plan_lib.cache("partition_gain")


def plan(n: int, d: int, k: int, device=None) -> plan_lib.LaunchPlan:
    """The launch over ``n`` rows of ``d`` slots and ``k`` bins on
    ``device``'s card (the H100's limits without one), cached by shape."""
    return _plans.get_or_build((n, d, k, device), lambda: _plan(
        n, d, k, plan_lib.device_model(device)))


def _plan(n: int, d: int, k: int,
          model: plan_lib.DeviceModel) -> plan_lib.LaunchPlan:
    t = tile(n, d, k, model.sms)
    rows = t.rows

    def tile_rows(b):
        return (b * rows, min(n, (b + 1) * rows))

    return plan_lib.LaunchPlan(
        name="partition_gain", entry="partition_gain",
        kernel="partition_gain_kernel", grid=(-(-n // rows),),
        threads=(t.threads,), dyn_smem=8 * rows * t.d_chunk,
        operands=(plan_lib.Arg("part", (n,), "int32"),
                  plan_lib.Arg("nbr_idx", (n, d), "int32"),
                  plan_lib.Arg("nbr_w", (n, d), "float32")),
        outputs=(plan_lib.Arg("conn", (n, k), "float32"),),
        writes=(lambda b: [((b * rows, (b + 1) * rows), (0, k))],),
        reads=(plan_lib.INDIRECT,
               lambda b: [(tile_rows(b), (0, d))],
               lambda b: [(tile_rows(b), (0, d))]),
        masked_edges=((True, False),),
        args={"rows": rows, "d_chunk": t.d_chunk})


def example_plans():
    """The reference's example (``n=1000, d=8, k=8``), and the serve
    pool's one-row blocks."""
    return [plan(1000, 8, 8), plan(48, 6, 4)]


def launch(p: plan_lib.LaunchPlan, part, nbr_idx, nbr_w, conn,
           stream=None) -> None:
    """One launch of ``p`` on the wrapper's checked tensors."""
    n, d = nbr_idx.shape
    fn = build.entry("partition_gain", [ctypes.c_void_p] * 4
                     + [ctypes.c_int] * 5 + build.LAUNCH_ARGTYPES)
    build.check("partition_gain", fn(
        build.ptr(part), build.ptr(nbr_idx), build.ptr(nbr_w),
        build.ptr(conn), n, d, conn.shape[1], p.args["rows"],
        p.args["d_chunk"], *p.launch_dims(),
        build.stream_of(part.device) if stream is None else stream))


def partition_gain(part: torch.Tensor, nbr_idx: torch.Tensor,
                   nbr_w: torch.Tensor, k: int) -> torch.Tensor:
    """conn ``[n, k]`` float32 from ``part`` int32 ``[n]`` and the ELL
    ``nbr_idx`` int32 / ``nbr_w`` float32 ``[n, D]``: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    global launches
    dev = part.device
    if dev.type == "cpu":
        return plain(part, nbr_idx, nbr_w, k)
    if dev.type != "cuda":
        raise ValueError(f"partition_gain: no kernel for device {dev}")
    n = part.shape[0]
    d = nbr_idx.shape[1] if nbr_idx.dim() == 2 else -1
    build.require(part, "partition_gain part", torch.int32, dev, (n,))
    build.require(nbr_idx, "partition_gain nbr_idx", torch.int32, dev, (n, d))
    build.require(nbr_w, "partition_gain nbr_w", torch.float32, dev, (n, d))
    if n == 0:
        return torch.empty(0, k, dtype=torch.float32, device=dev)
    p = plan(n, d, k, dev)
    conn = torch.empty(n, k, dtype=torch.float32, device=dev)
    launch(p, part, nbr_idx, nbr_w, conn)
    launches += 1
    return conn
