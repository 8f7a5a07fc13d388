"""Shared model pieces: twin of ``repro/models/common.py`` (norms,
activations, RoPE, the chunked flash-attention forward, its quadratic
oracle and ``cross_entropy``).

``flash_attention`` here is the twin of the reference's pure-JAX ``_flash``
forward and the plain version of the hand-written ``flash_attention`` CUDA
kernel (``kernels/flash_attention.py``): CPU tensors run it, and the model
reaches it through ``kernels.ops.flash_attention``, which launches the
kernel on CUDA tensors. Its backward (the reference's ``_flash_bwd``
recompute) is not ported: the port serves, it does not train yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS statistics in f32, normalization on the x-dtype path: ``inv`` is
    cast to x's dtype and ``x * inv * gamma`` is taken in that order, as the
    reference does."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * gamma


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_freqs(d_head: int, max_len: int, theta: float = 1e4,
               device=None) -> torch.Tensor:
    """[max_len, d_head // 2] angles, computed in float64 on the host and
    cast to float32, as the reference does."""
    inv = 1.0 / (theta ** (np.arange(0, d_head, 2) / d_head))
    t = np.arange(max_len)
    return torch.as_tensor(np.outer(t, inv).astype(np.float32), device=device)


def rope_tables(angles: torch.Tensor, dtype: torch.dtype):
    """(cos, sin) of ``angles`` [..., S, D//2] as [..., S, 1, D//2] in
    ``dtype``: computed once and shared by every layer of a step."""
    return (torch.cos(angles)[..., :, None, :].to(dtype),
            torch.sin(angles)[..., :, None, :].to(dtype))


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """x: [..., S, H, D] rotated by the tables of :func:`rope_tables`."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [..., S, H, D]; angles: [S, D//2] (already offset for decode)."""
    return rotate(x, *rope_tables(angles, x.dtype))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 512) -> torch.Tensor:
    """Chunked online-softmax attention forward, the twin of ``_flash``'s
    forward (``_flash_fwd_impl``).

    q: [B, Sq, H, D]; k: [B, Sk, Kh, D]; v: [B, Sk, Kh, Dv], H a multiple of
    Kh (GQA). Returns [B, Sq, H, Dv] in q's dtype. The causal mask is
    top-left aligned (``k_pos <= q_pos``); keys at or beyond ``Sk`` are
    masked. Scores, the running max and sum and the accumulator are float32
    (the reference's ``preferred_element_type``: the products of the
    working type are formed in float32); P is rounded to v's dtype before
    the PV product. A chunk of 0 means the full length.
    """
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    dv = v.shape[-1]
    g = h // kh
    scale = 1.0 / np.sqrt(d)
    q_chunk = min(q_chunk or sq, sq)
    kv_chunk = min(kv_chunk or sk, sk)
    nq = (sq + q_chunk - 1) // q_chunk
    nk = (sk + kv_chunk - 1) // kv_chunk
    pad = torch.nn.functional.pad
    qb = pad(q, (0, 0, 0, 0, 0, nq * q_chunk - sq)).reshape(
        b, nq, q_chunk, kh, g, d)
    kb = pad(k, (0, 0, 0, 0, 0, nk * kv_chunk - sk)).reshape(
        b, nk, kv_chunk, kh, d)
    vb = pad(v, (0, 0, 0, 0, 0, nk * kv_chunk - sk)).reshape(
        b, nk, kv_chunk, kh, dv)
    f32 = torch.float32
    out = torch.empty((b, nq, q_chunk, kh, g, dv), dtype=q.dtype,
                      device=q.device)
    for qi in range(nq):
        q_i = qb[:, qi].to(f32)
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        acc = torch.zeros((b, q_chunk, kh, g, dv), dtype=f32, device=q.device)
        m = torch.full((b, q_chunk, kh, g), -torch.inf, dtype=f32,
                       device=q.device)
        l = torch.zeros((b, q_chunk, kh, g), dtype=f32, device=q.device)
        for kj in range(nk):
            k_j, v_j = kb[:, kj], vb[:, kj]
            s = torch.einsum("bqhgd,bkhd->bqhgk", q_i, k_j.to(f32)) * scale
            k_pos = kj * kv_chunk + torch.arange(kv_chunk, device=q.device)
            mask = k_pos[None, :] < sk
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            s = torch.where(mask[None, :, None, None, :], s, -torch.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(torch.isfinite(m_new)[..., None], p, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p.to(v_j.dtype).to(f32), v_j.to(f32))
            m = m_new
        out[:, qi] = (acc / torch.clamp_min(l[..., None], 1e-20)).to(q.dtype)
    return out.reshape(b, nq * q_chunk, h, dv)[:, :sq]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Quadratic oracle for flash_attention tests. Its causal mask is
    bottom-right aligned (``tril(k=sk-sq)``), so it agrees with
    :func:`flash_attention` only where ``Sq == Sk``."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    kf = torch.repeat_interleave(k, g, dim=2)
    vf = torch.repeat_interleave(v, g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kf).to(torch.float32) / np.sqrt(d)
    if causal:
        mask = torch.tril(torch.ones((sq, sk), dtype=torch.bool,
                                     device=q.device), diagonal=sk - sq)
        s = torch.where(mask[None, None], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), vf)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over (masked) tokens; logits [.., V], labels [..] int."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[..., None],
                                dim=-1)[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
