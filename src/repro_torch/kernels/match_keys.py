"""Jittered matching keys for device heavy-edge coarsening.

Replaces the Pallas kernel ``repro/kernels/match_keys.py:match_keys_tiled``
with ``csrc/match_keys.cu``. One matching round of
``core.coarsen.coarsen_device`` ranks every arc by a jittered weight, masked
to arcs whose endpoints are both still eligible:

    key[a] = w[a] * (1 + 0.01 * u[a])   if mask[a] > 0 else  -1.0

On the H100 this is a streaming map bound by device-memory bytes (16 B per
arc: three loads, one store); the kernel is one coalesced grid-stride pass
whose arithmetic cannot be contracted into an FMA, so it equals the plain
version bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches of the CUDA kernel (plain CPU calls do not count)
launches = 0


def plain(w: torch.Tensor, u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path)."""
    return torch.where(mask > 0, w * (1.0 + 0.01 * u),
                       torch.full_like(w, -1.0))


def match_keys(w: torch.Tensor, u: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Masked jittered keys ``[m]`` float32 of a flat arc list: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    global launches
    if w.device.type == "cpu":
        return plain(w, u, mask)
    if w.device.type != "cuda":
        raise ValueError(f"match_keys: no kernel for device {w.device}")
    m = w.shape[0]
    for t, what in ((w, "w"), (u, "u"), (mask, "mask")):
        build.require(t, f"match_keys {what}", torch.float32, w.device, (m,))
    out = torch.empty_like(w)
    fn = build.entry("match_keys", [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    build.check("match_keys", fn(build.ptr(w), build.ptr(u), build.ptr(mask),
                                 build.ptr(out), m, build.sm_count(w.device),
                                 build.stream_of(w.device)))
    launches += 1
    return out
