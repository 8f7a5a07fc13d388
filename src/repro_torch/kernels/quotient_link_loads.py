"""Fused makespan-communication op: arc list -> per-link loads.

Replaces the Pallas kernel
``repro/kernels/quotient_link_loads.py:quotient_link_loads`` (and the
``part[senders]`` / ``part[receivers]`` gathers of
``repro/kernels/ops.py:link_loads``) with ``csrc/quotient_link_loads.cu``:

    W[i, j] = sum of w over arcs with part[s] = i, part[r] = j      [k, k]
    out[l]  = F_l * 0.5 * (S r + S c - 2 diag(S W S^T))[l]           [L]

The TPU kernel carries W in VMEM across a sequential grid; Hopper blocks run
in no order, so the CUDA version is a scatter launch (block-private W in
shared memory for k <= 110, global atomics above) and a one-block-per-link
epilogue, both written by hand. It is bound by the 12 B per arc it streams
(~5.9 us at m = 1.5M arcs on an H100). Float atomics vary the summation
order, so it matches the plain version to allclose (rtol 1e-4, atol 1e-3),
not bitwise. Call it with ``F_l = ones`` where raw comm is needed.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

launches = 0


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
    W = torch.zeros(k * k, dtype=torch.float32, device=dev)
    out = torch.empty(n_links, dtype=torch.float32, device=dev)
    fn = build.entry("quotient_link_loads", [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p])
    build.check("quotient_link_loads", fn(
        build.ptr(part), build.ptr(senders), build.ptr(receivers),
        build.ptr(weight), m, build.ptr(subtree), build.ptr(F_l), n_links, k,
        build.ptr(W), build.ptr(out), build.sm_count(dev),
        build.stream_of(dev)))
    launches += 1
    return out, W.view(k, k)
