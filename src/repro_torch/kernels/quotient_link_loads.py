"""Fused makespan-communication op: arc list -> per-link loads.

Replaces the Pallas kernel
``repro/kernels/quotient_link_loads.py:quotient_link_loads`` (and the
``part[senders]`` / ``part[receivers]`` gathers of
``repro/kernels/ops.py:link_loads``) with ``csrc/quotient_link_loads.cu``:

    W[i, j] = sum of w over arcs with part[s] = i, part[r] = j      [k, k]
    out[l]  = F_l * 0.5 * (S r + S c - 2 diag(S W S^T))[l]           [L]

The TPU kernel carries W in VMEM across a sequential grid; on Hopper one
cooperative launch does the whole call, with no fill before it: blocks over
contiguous chunks of the CSR-ordered arcs (one block for short lists,
:func:`qll_path`) add W into one half of a device workspace while zeroing
the other, meet at one grid barrier, and every warp then sums its links'
share from W in L2. The workspace (two halves of k*k floats and their
barrier counters) is allocated here once per device and k, zeroed, and the
half flips with every call; calls that share it must be ordered, so the
kernel runs on the current stream only. It is bound by the 12 B per arc it
streams (~5.9 us at m = 1.5M arcs on an H100). Float atomics vary the
summation order, so it matches the plain version to allclose (rtol 1e-4,
atol 1e-3), not bitwise. Call it with ``F_l = ones`` where raw comm is
needed. The launch comes from :func:`plan` (``kernels/plan.py``): its
grid is :func:`qll_path`'s, cut to the blocks the card holds at once, and
the launcher refuses a grid past that rather than cutting it.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plan as plan_lib

launches = 0
# launches by (arcs m, vertices n, bins k, links L), reset with the count
launch_shapes: collections.Counter = collections.Counter()

# blocks of THREADS threads (__launch_bounds__(512, 2): two blocks an SM
# are guaranteed the registers); arc lists up to SINGLE_BLOCK_ARCS run as one
# block (measured crossover, PERF.md section 6), longer ones on a grid with
# at least ARCS_PER_BLOCK arcs a block and at most BLOCKS_PER_SM per SM (the
# launch is cooperative: every block resident at once)
THREADS = 512
SMEM_W_BYTES = 64 * 1024      # a block's W in shared memory up to k = 128
SINGLE_BLOCK_ARCS = 2_048
ARCS_PER_BLOCK = 2_048
BLOCKS_PER_SM = 2

# the workspace by (device, k): two halves of k*k floats and their barrier
# counters, zeroed once; and the half the next call on it takes
_workspaces: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_halves: Dict[Tuple[torch.device, int], int] = {}


class QllPath(NamedTuple):
    blocks: int
    threads: int
    smem: int           # bytes of each block's W in shared memory, or 0


def qll_path(m: int, k: int, n_sm: int) -> QllPath:
    """The launch for ``m`` arcs and ``k`` bins on a card with ``n_sm`` SMs:
    one block while ``m <=
    SINGLE_BLOCK_ARCS``, else a grid over contiguous chunks of the arcs, at
    least ``ARCS_PER_BLOCK`` each and at most ``BLOCKS_PER_SM`` per SM;
    each block keeps its own W in shared memory while it is at most
    ``SMEM_W_BYTES``."""
    blocks = (1 if m <= SINGLE_BLOCK_ARCS else
              max(1, min(-(-m // ARCS_PER_BLOCK), n_sm * BLOCKS_PER_SM)))
    smem = 4 * k * k
    return QllPath(blocks, THREADS, smem if smem <= SMEM_W_BYTES else 0)


_plans = plan_lib.cache("quotient_link_loads")
_SPAN = 128                   # arcs a warp step (32 lanes x 4 in flight)


def plan(m: int, n: int, k: int, n_links: int,
         device=None) -> plan_lib.LaunchPlan:
    """The cooperative launch over ``m`` arcs of ``n`` vertices, ``k``
    bins and ``n_links`` links on ``device``'s card (the H100's limits
    without one), cached by shape."""
    return _plans.get_or_build((m, n, k, n_links, device), lambda: _plan(
        m, n, k, n_links, device))


def _plan(m, n, k, n_links, device, blocks=None):
    model = plan_lib.device_model(device)
    path = qll_path(m, k, model.sms)
    kernel = "qll_kernel<true>" if path.smem else "qll_kernel<false>"
    if blocks is None:
        per_sm = plan_lib.occupancy("quotient_link_loads", kernel,
                                    path.threads, path.smem, BLOCKS_PER_SM,
                                    device)
        blocks = max(1, min(path.blocks, per_sm * model.sms))
    per_block = -(-(-(-m // blocks)) // _SPAN) * _SPAN
    kk = k * k

    def arcs(b):
        lo = min(m, b * per_block)
        return [((lo, min(m, lo + per_block)),)]

    def whole(*shape):
        return lambda b: [tuple((0, s) for s in shape)]

    return plan_lib.LaunchPlan(
        name="quotient_link_loads", entry="quotient_link_loads",
        kernel=kernel, grid=(blocks,), threads=(path.threads,),
        dyn_smem=path.smem, smem_optin=path.smem > 48 * 1024,
        cooperative=True, min_blocks_per_sm=BLOCKS_PER_SM,
        operands=(plan_lib.Arg("part", (n,), "int32"),
                  plan_lib.Arg("senders", (m,), "int32"),
                  plan_lib.Arg("receivers", (m,), "int32"),
                  plan_lib.Arg("weight", (m,), "float32"),
                  plan_lib.Arg("subtree", (n_links, k), "float32"),
                  plan_lib.Arg("F_l", (n_links,), "float32"),
                  plan_lib.Arg("work", (2 * kk + 2,), "float32")),
        outputs=(plan_lib.Arg("W", (kk,), "float32"),
                 plan_lib.Arg("out", (n_links,), "float32")),
        # W: a slice a block after the barrier; out: zeroed by block 0
        # before it, then the links' sums added atomically
        writes=(lambda b: [plan_lib.Tile(
                    ((kk * b // blocks, kk * (b + 1) // blocks),), 1)],
                lambda b: [plan_lib.Tile(((0, n_links),), 0)] if b == 0
                else []),
        reads=(plan_lib.INDIRECT, arcs, arcs, arcs,
               whole(n_links, k), whole(n_links), plan_lib.INDIRECT),
        masked_edges=((False,), (False,)),
        atomic_outputs=(1,), phases=2,
        args={"path": "smem_w" if path.smem else "global_w",
              "per_block": per_block})


def example_plans():
    """The reference's example (``m=2048, k=16, L=20``: one block), then W
    in shared memory on a grid (k = 64) and in device memory (k = 512)."""
    return [plan(2048, 1000, 16, 20), plan(122_656, 30_000, 64, 126),
            plan(1_548_288, 262_144, 512, 584)]


def launch(p: plan_lib.LaunchPlan, part, senders, receivers, weight, subtree,
           F_l, W, out, work, half, stream=None) -> None:
    """One launch of ``p`` on the wrapper's checked tensors."""
    fn = build.entry("quotient_link_loads", [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int] + build.LAUNCH_ARGTYPES)
    build.check("quotient_link_loads", fn(
        build.ptr(part), build.ptr(senders), build.ptr(receivers),
        build.ptr(weight), senders.shape[0], build.ptr(subtree),
        build.ptr(F_l), subtree.shape[0], subtree.shape[1], build.ptr(W),
        build.ptr(out), build.ptr(work), half, *p.launch_dims(),
        build.stream_of(part.device) if stream is None else stream))


def _workspace(dev: torch.device, k: int) -> Tuple[torch.Tensor, int]:
    """The workspace for ``k`` on ``dev`` and the half this call takes; the
    kernel zeroes the other half, so every call finds its own half zero."""
    key = (dev, k)
    if key not in _workspaces:
        _workspaces[key] = torch.zeros(2 * k * k + 2, dtype=torch.float32,
                                       device=dev)
        _halves[key] = 0
    half = _halves[key]
    _halves[key] = 1 - half
    return _workspaces[key], half


def quotient_matrix(part: torch.Tensor, senders: torch.Tensor,
                    receivers: torch.Tensor, edge_weight: torch.Tensor,
                    k: int) -> torch.Tensor:
    """W[i, j] = total arc weight from bin i to bin j. [k, k]"""
    bi = part[senders].long()
    bj = part[receivers].long()
    flat = torch.zeros(k * k, dtype=edge_weight.dtype,
                       device=edge_weight.device)
    flat.index_add_(0, bi * k + bj, edge_weight)
    return flat.view(k, k)


def link_loads_tree(W: torch.Tensor, subtree: torch.Tensor) -> torch.Tensor:
    """comm(l) for a tree from the (symmetric, arc-based) quotient matrix,
    counting each undirected edge once. [L]"""
    S = subtree
    cross = ((S @ W) * S).sum(dim=1)
    return 0.5 * (S @ W.sum(1) + S @ W.sum(0) - 2.0 * cross)


def plain(part: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor,
          weight: torch.Tensor, subtree: torch.Tensor, F_l: torch.Tensor,
          k: int) -> torch.Tensor:
    """The same function in plain PyTorch: ``index_add_`` quotient matrix
    and the subtree-XOR identity as products."""
    return _plain_with_quotient(part, senders, receivers, weight, subtree,
                                F_l, k)[0]


def _plain_with_quotient(part, senders, receivers, weight, subtree, F_l, k):
    W = quotient_matrix(part, senders, receivers, weight.to(torch.float32), k)
    return F_l * link_loads_tree(W, subtree), W


def quotient_link_loads(part: torch.Tensor, senders: torch.Tensor,
                        receivers: torch.Tensor, weight: torch.Tensor,
                        subtree: torch.Tensor, F_l: torch.Tensor,
                        k: int) -> torch.Tensor:
    """``F_l * comm(l)`` ``[L]`` float32: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors. ``part`` is int32 ``[n]``;
    ``senders``/``receivers`` int32 ``[m]``; ``subtree`` ``[L, k]``."""
    return loads_and_quotient(part, senders, receivers, weight, subtree, F_l,
                              k)[0]


def loads_and_quotient(part: torch.Tensor, senders: torch.Tensor,
                       receivers: torch.Tensor, weight: torch.Tensor,
                       subtree: torch.Tensor, F_l: torch.Tensor,
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(F_l * comm [L], W [k, k])``: the loads of
    :func:`quotient_link_loads` and the quotient matrix they were summed
    from (the kernel's own W buffer on a CUDA tensor)."""
    global launches
    dev = part.device
    if dev.type == "cpu":
        return _plain_with_quotient(part, senders, receivers, weight,
                                    subtree, F_l, k)
    if dev.type != "cuda":
        raise ValueError(f"quotient_link_loads: no kernel for device {dev}")
    m = senders.shape[0]
    n_links = subtree.shape[0]
    build.require(part, "quotient_link_loads part", torch.int32, dev,
                  (part.shape[0],))
    build.require(senders, "quotient_link_loads senders", torch.int32, dev,
                  (m,))
    build.require(receivers, "quotient_link_loads receivers", torch.int32,
                  dev, (m,))
    build.require(weight, "quotient_link_loads weight", torch.float32, dev,
                  (m,))
    build.require(subtree, "quotient_link_loads subtree", torch.float32, dev,
                  (n_links, k))
    build.require(F_l, "quotient_link_loads F_l", torch.float32, dev,
                  (n_links,))
    p = plan(m, int(part.shape[0]), k, n_links, dev)
    W = torch.empty(k * k, dtype=torch.float32, device=dev)
    out = torch.empty(n_links, dtype=torch.float32, device=dev)
    work, half = _workspace(dev, k)
    launch(p, part, senders, receivers, weight, subtree, F_l, W, out, work,
           half)
    launches += 1
    launch_shapes[(m, int(part.shape[0]), k, n_links)] += 1
    return out, W.view(k, k)
