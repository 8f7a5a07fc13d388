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
needed.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build

launches = 0
# launches by (arcs m, vertices n, bins k, links L), reset with the count
launch_shapes: collections.Counter = collections.Counter()

# blocks of THREADS threads; arc lists up to SINGLE_BLOCK_ARCS run as one
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
    sms = build.sm_count(dev)
    path = qll_path(m, k, sms)
    W = torch.empty(k * k, dtype=torch.float32, device=dev)
    out = torch.empty(n_links, dtype=torch.float32, device=dev)
    work, half = _workspace(dev, k)
    fn = build.entry("quotient_link_loads", [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p])
    build.check("quotient_link_loads", fn(
        build.ptr(part), build.ptr(senders), build.ptr(receivers),
        build.ptr(weight), m, build.ptr(subtree), build.ptr(F_l), n_links, k,
        build.ptr(W), build.ptr(out), build.ptr(work), half, path.blocks,
        path.threads, path.smem, sms, build.stream_of(dev)))
    launches += 1
    launch_shapes[(m, int(part.shape[0]), k, n_links)] += 1
    return out, W.view(k, k)
