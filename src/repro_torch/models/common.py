"""Shared model pieces: twin of ``repro/models/common.py`` (norms,
activations, RoPE, the chunked flash-attention forward, its quadratic
oracle and ``cross_entropy``).

``flash_attention_fwd`` is the twin of the reference's pure-JAX
``_flash_fwd_impl`` (the output and the log-sum-exp the backward needs) and
the plain version of the hand-written ``flash_attention`` CUDA kernel
(``kernels/flash_attention.py``); ``flash_attention`` is its output alone,
the twin of ``_flash``. ``flash_attention_bwd`` is the twin of
``_flash_bwd``, the FlashAttention-2 recompute from ``(q, k, v, out,
lse)``: plain PyTorch on either device (the reference's backward is pure
JAX, not a TPU kernel). The model reaches both through
``kernels.ops.flash_attention``, whose ``torch.autograd.Function`` runs the
kernel's forward on CUDA tensors and this backward.
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


def _chunks(sq: int, sk: int, q_chunk: int, kv_chunk: int):
    """(q_chunk, kv_chunk, nq, nk) with a chunk of 0 meaning the full
    length, as the reference clamps them."""
    q_chunk = min(q_chunk or sq, sq)
    kv_chunk = min(kv_chunk or sk, sk)
    return (q_chunk, kv_chunk, (sq + q_chunk - 1) // q_chunk,
            (sk + kv_chunk - 1) // kv_chunk)


def _pad_seq(x: torch.Tensor, n: int, value: float = 0.0) -> torch.Tensor:
    """x [B, S, ...] padded with ``n`` rows of ``value`` on axis 1."""
    return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, n),
                                   value=value)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_chunk: int = 512,
                        kv_chunk: int = 512):
    """Chunked online-softmax attention forward, the twin of
    ``_flash_fwd_impl``: returns ``(out, lse)``.

    q: [B, Sq, H, D]; k: [B, Sk, Kh, D]; v: [B, Sk, Kh, Dv], H a multiple of
    Kh (GQA). ``out`` is [B, Sq, H, Dv] in q's dtype. ``lse`` is float32
    [B, Sq, H], each row's log-sum-exp of the scaled scores, ``m + log(max(l,
    1e-30))`` and -inf where ``l == 0`` (the reference's [B, Sq, Kh, G] is
    the same memory: query head ``h`` sits on KV head ``h // G``). The
    causal mask is top-left aligned (``k_pos <= q_pos``); keys at or beyond
    ``Sk`` are masked. Scores, the running max and sum and the accumulator
    are float32 (the reference's ``preferred_element_type``: the products
    of the working type are formed in float32); P is rounded to v's dtype
    before the PV product. A chunk of 0 means the full length.
    """
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    dv = v.shape[-1]
    g = h // kh
    scale = 1.0 / np.sqrt(d)
    q_chunk, kv_chunk, nq, nk = _chunks(sq, sk, q_chunk, kv_chunk)
    qb = _pad_seq(q, nq * q_chunk - sq).reshape(b, nq, q_chunk, kh, g, d)
    kb = _pad_seq(k, nk * kv_chunk - sk).reshape(b, nk, kv_chunk, kh, d)
    vb = _pad_seq(v, nk * kv_chunk - sk).reshape(b, nk, kv_chunk, kh, dv)
    f32 = torch.float32
    out = torch.empty((b, nq, q_chunk, kh, g, dv), dtype=q.dtype,
                      device=q.device)
    lse = torch.empty((b, nq, q_chunk, kh, g), dtype=f32, device=q.device)
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
        lse[:, qi] = torch.where(
            l > 0, m + torch.log(torch.clamp_min(l, 1e-30)), -torch.inf)
    return (out.reshape(b, nq * q_chunk, h, dv)[:, :sq],
            lse.reshape(b, nq * q_chunk, h)[:, :sq])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 512) -> torch.Tensor:
    """The output of :func:`flash_attention_fwd` alone (the twin of
    ``_flash``'s forward): [B, Sq, H, Dv] in q's dtype."""
    return flash_attention_fwd(q, k, v, causal, q_chunk, kv_chunk)[0]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool = True,
                        q_chunk: int = 512, kv_chunk: int = 512):
    """The FlashAttention-2 recompute, the twin of ``_flash_bwd``: (dq, dk,
    dv) in the dtypes of q, k and v from the forward's residuals and the
    output's cotangent ``do`` [B, Sq, H, Dv]; ``lse`` is float32 [B, Sq,
    H] as :func:`flash_attention_fwd` returns it.

    The reference's chunking: every q chunk at once against one kv chunk at
    a time (the causal mask zeroes what lies above the diagonal; nothing is
    skipped), ``delta = sum(do * o)``, ``p = exp(s - lse)`` zeroed where
    lse is not finite, dq accumulated in float32 over kv chunks. Its
    ``preferred_element_type=float32`` products of the working type are
    float32 products of upcast operands here, with the reference's
    roundings: ``do`` goes to v's dtype for ``dp``, ``ds`` to k's dtype
    for dq and to q's for dk; ``dv`` takes ``p`` and ``do`` in float32.
    """
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    dv = v.shape[-1]
    g = h // kh
    scale = 1.0 / np.sqrt(d)
    q_chunk, kv_chunk, nq, nk = _chunks(sq, sk, q_chunk, kv_chunk)
    pad_q, pad_k = nq * q_chunk - sq, nk * kv_chunk - sk
    f32 = torch.float32
    qb = _pad_seq(q, pad_q).reshape(b, nq, q_chunk, kh, g, d).to(f32)
    dob = _pad_seq(do, pad_q).reshape(b, nq, q_chunk, kh, g, dv)
    ob = _pad_seq(out, pad_q).reshape(b, nq, q_chunk, kh, g, dv)
    lseb = _pad_seq(lse.reshape(b, sq, kh, g), pad_q,
                    value=-torch.inf).reshape(b, nq, q_chunk, kh, g)
    kb = _pad_seq(k, pad_k).reshape(b, nk, kv_chunk, kh, d)
    vb = _pad_seq(v, pad_k).reshape(b, nk, kv_chunk, kh, dv)

    do32 = dob.to(f32)
    do_v = dob.to(v.dtype).to(f32)
    delta = torch.sum(do32 * ob.to(f32), dim=-1)           # [B,nq,qc,Kh,G]
    del ob
    finite = torch.isfinite(lseb)[..., None]
    q_pos = (torch.arange(nq, device=q.device)[:, None] * q_chunk
             + torch.arange(q_chunk, device=q.device)[None, :])   # [nq, qc]
    dq = torch.zeros((b, nq, q_chunk, kh, g, d), dtype=f32, device=q.device)
    dk = torch.empty((b, nk, kv_chunk, kh, d), dtype=f32, device=q.device)
    dv_ = torch.empty((b, nk, kv_chunk, kh, dv), dtype=f32, device=q.device)
    for kj in range(nk):
        k_j, v_j = kb[:, kj].to(f32), vb[:, kj].to(f32)   # [B,kc,Kh,*]
        s = torch.einsum("bnqhgd,bkhd->bnqhgk", qb, k_j) * scale
        k_pos = kj * kv_chunk + torch.arange(kv_chunk, device=q.device)
        mask = k_pos[None, None, :] < sk
        if causal:
            mask = mask & (k_pos[None, None, :] <= q_pos[..., None])
        s = torch.where(mask[None, :, :, None, None, :], s, -torch.inf)
        p = torch.exp(s - lseb[..., None])
        del s
        p = torch.where(finite, p, 0.0)
        dv_[:, kj] = torch.einsum("bnqhgk,bnqhgd->bkhd", p, do32)
        dp = torch.einsum("bnqhgd,bkhd->bnqhgk", do_v, v_j)
        ds = p * (dp - delta[..., None]) * scale
        del p, dp
        dq += torch.einsum("bnqhgk,bkhd->bnqhgd",
                           ds.to(k.dtype).to(f32), k_j)
        dk[:, kj] = torch.einsum("bnqhgk,bnqhgd->bkhd",
                                 ds.to(q.dtype).to(f32), qb)
    dq = dq.reshape(b, nq * q_chunk, h, d)[:, :sq].to(q.dtype)
    dk = dk.reshape(b, nk * kv_chunk, kh, d)[:, :sk].to(k.dtype)
    dv_ = dv_.reshape(b, nk * kv_chunk, kh, dv)[:, :sk].to(v.dtype)
    return dq, dk, dv_


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


# rows of the [tokens, vocab] logits taken to float32 at once by
# cross_entropy: 2,048 x 151,936 x 4 bytes = 1.2 GB at Qwen2-1.5B's vocab
CE_ROWS = 2048


class _TokenNLL(torch.autograd.Function):
    """``nll[t] = logsumexp(x[t]) - x[t, label[t]]`` in float32 over row
    chunks of the logits. Autograd through the whole-tensor expression
    keeps a float32 copy of the logits for its backward and makes two more
    (the softmax and the scattered gold term): 10 GB each at 4 x 4,096
    tokens of a 151,936-word vocabulary. This keeps the logits in their own
    type and recomputes each chunk's float32 rows in the backward, with the
    same operations autograd would run: ``g * exp(x - lse)``, then ``-g``
    added at the gold column."""

    @staticmethod
    def forward(ctx, logits, labels):
        x = logits.reshape(-1, logits.shape[-1])
        lab = labels.reshape(-1, 1).long()
        lse = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        gold = torch.empty_like(lse)
        for r in range(0, x.shape[0], CE_ROWS):
            xf = x[r:r + CE_ROWS].to(torch.float32)
            lse[r:r + CE_ROWS] = torch.logsumexp(xf, dim=-1)
            gold[r:r + CE_ROWS] = torch.take_along_dim(
                xf, lab[r:r + CE_ROWS], dim=-1)[:, 0]
        ctx.save_for_backward(logits, lab, lse)
        return (lse - gold).reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        logits, lab, lse = ctx.saved_tensors
        x = logits.reshape(-1, logits.shape[-1])
        g = g.reshape(-1, 1).to(torch.float32)
        grad = torch.empty_like(x)
        for r in range(0, x.shape[0], CE_ROWS):
            rows = slice(r, r + CE_ROWS)
            gx = g[rows] * torch.exp(x[rows].to(torch.float32)
                                     - lse[rows, None])
            gx.scatter_add_(-1, lab[rows], -g[rows])
            grad[rows] = gx.to(grad.dtype)
        return grad.reshape(logits.shape), None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over (masked) tokens; logits [.., V], labels [..] int. The
    reference's float32 ``logsumexp - gold`` per token, taken over row
    chunks (``_TokenNLL``) so the float32 logits are never whole."""
    nll = _TokenNLL.apply(logits, labels)
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
