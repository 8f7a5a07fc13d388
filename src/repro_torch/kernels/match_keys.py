"""Jittered matching keys for device heavy-edge coarsening, and the whole
matching round they feed.

Replaces the Pallas kernel ``repro/kernels/match_keys.py:match_keys_tiled``
with ``csrc/match_keys.cu``. One matching round of
``core.coarsen.coarsen_device`` ranks every arc by a jittered weight, masked
to arcs whose endpoints are both still eligible:

    key[a] = w[a] * (1 + 0.01 * u[a])   if mask[a] > 0 else  -1.0

then takes, per sender, the arc of the largest key (the largest arc id
among equal keys). ``match_keys`` is the map alone, the twin of the
reference's ``ops.match_keys``: a streaming map bound by device-memory
bytes (16 B per arc: three loads, one store), one coalesced grid-stride
pass whose arithmetic cannot be contracted into an FMA, so it equals the
plain version bit for bit. ``match_round`` is what the port's coarsening
calls: the mask, the keys and both segment maxima of the round in one
cooperative launch, the key never written, each sender's winner found by a
64-bit ``atomicMax`` of ``(key bits << 32) | arc id`` (positive float bits
order as unsigned integers), so it equals :func:`match_round_plain`, the
reference's sequence, bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build

# launches of the CUDA kernels (plain CPU calls do not count): the map,
# and the fused round
launches = 0
round_launches = 0

# the fused round's workspace by device: one 64-bit word of barrier
# counters, then one word per vertex, zero between calls
_words: Dict[torch.device, torch.Tensor] = {}


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


def match_round_plain(s: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                      u: torch.Tensor, matched: torch.Tensor) -> torch.Tensor:
    """The round as the reference computes it
    (``repro/core/coarsen.py:138-151``): the mask from the endpoints'
    eligibility and ``w > 0``, the keys, the per-sender max key, then the
    max arc id among the live arcs attaining it. ``best_arc`` [n] int32,
    -1 where a vertex has no live arc (the reference's empty segments hold
    the int minimum; both only ever test ``>= 0``)."""
    # imported here: core.objective imports this package
    from repro_torch.core.objective import segment_max
    n, m = matched.shape[0], w.shape[0]
    s64, r64 = s.long(), r.long()
    elig = (~matched).to(torch.float32)
    mask = elig[s64] * elig[r64] * (w > 0).to(torch.float32)
    keys = plain(w, u, mask)
    seg = segment_max(keys, s64, n)
    at_max = (keys > 0) & (keys >= seg[s64])
    iota_m = torch.arange(m, dtype=torch.int32, device=w.device)
    no_arc = torch.full_like(iota_m, -1)
    best = segment_max(torch.where(at_max, iota_m, no_arc), s64, n)
    return best.clamp_min(-1)


def _word_buffer(dev: torch.device, n: int) -> torch.Tensor:
    """The barrier word and at least ``n`` zero words on ``dev``."""
    buf = _words.get(dev)
    if buf is None or buf.numel() < n + 1:
        buf = torch.zeros(max(n, 1024) + 1, dtype=torch.int64, device=dev)
        _words[dev] = buf
    return buf


def match_round(s: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                u: torch.Tensor, matched: torch.Tensor) -> torch.Tensor:
    """One matching round over the CSR-sorted arc list ``s``/``r`` (int32
    [m]), ``w``/``u`` (float32 [m]) with ``matched`` (bool [n]): per sender,
    the live arc of the largest jittered key, the largest arc id among
    equal keys; -1 where none. ``best_arc`` [n] int32: the plain version
    for CPU tensors, the fused CUDA kernel for CUDA tensors."""
    global round_launches
    dev = w.device
    if dev.type == "cpu":
        return match_round_plain(s, r, w, u, matched)
    if dev.type != "cuda":
        raise ValueError(f"match_round: no kernel for device {dev}")
    m, n = w.shape[0], matched.shape[0]
    if m >= 2 ** 31:
        raise ValueError(f"match_round: {m} arcs; arc ids are int32")
    build.require(s, "match_round s", torch.int32, dev, (m,))
    build.require(r, "match_round r", torch.int32, dev, (m,))
    build.require(w, "match_round w", torch.float32, dev, (m,))
    build.require(u, "match_round u", torch.float32, dev, (m,))
    build.require(matched, "match_round matched", torch.bool, dev, (n,))
    best = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return best
    words = _word_buffer(dev, n)
    fn = build.entry("match_round", [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    build.check("match_round", fn(
        build.ptr(s), build.ptr(r), build.ptr(w), build.ptr(u),
        build.ptr(matched), build.ptr(best), build.ptr(words), m, n,
        build.sm_count(dev), build.stream_of(dev)))
    round_launches += 1
    return best
