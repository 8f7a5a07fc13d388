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

On a process group's mesh the attention and the token loss are kernel
sites on real DTensors: :func:`attention_on_shards` and
:func:`token_nll` place their operands as the meta trace does
(:func:`_attn_layout`, :func:`_nll_layout`), run the kernel or the plain
version on each device's local shards, and wrap the results as DTensors,
differentiably; a vocab-sharded loss reduces its row statistics over the
vocab's devices (:class:`_VocabParallelNLL`).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.sharding import _contiguous_stride, _is_dtensor, dense
from repro_torch.kernels.cost_sites import (declare_attention,
                                            declare_token_nll, opaque)


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
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down``, each product through
    ``dist.sharding.dense`` (``@`` itself unless x is a DTensor)."""
    h = torch.nn.functional.silu(dense(x, w_gate)) * dense(x, w_up)
    return dense(h, w_down)


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
    """x: [..., S, H, D] rotated by the (plain) tables of
    :func:`rope_tables`. A DTensor whose sequence and head dims are whole
    on each device is rotated on its local shard (the same ops, without
    DTensor's dispatch around each of its nine)."""
    if _is_dtensor(x) and _rotates_locally(x):
        return _from_local(rotate(x.to_local(), cos, sin), x.device_mesh,
                           x.placements, x.shape)
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rotates_locally(x: torch.Tensor) -> bool:
    """x's placements shard neither its sequence (dim -3) nor its last dim,
    and none is partial."""
    from torch.distributed.tensor import Shard
    nd = x.dim()
    return not any(p.is_partial() or (isinstance(p, Shard) and p.dim % nd
                                      in (nd - 3, nd - 1))
                   for p in x.placements)


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


def _placed(x: torch.Tensor, want) -> torch.Tensor:
    """DTensor ``x`` redistributed to ``want`` (itself if it is so)."""
    want = tuple(want)
    return x if tuple(x.placements) == want else x.redistribute(
        x.device_mesh, want)


def _grad_placed(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Gradient ``g`` redistributed to the placements of its input ``x``,
    replicated where ``x`` is partial (each share of a sum has the sum's
    gradient), as DTensor places the gradient of a redistribution."""
    from torch.distributed.tensor import Replicate
    return _placed(g, [Replicate() if p.is_partial() else p
                       for p in x.placements])


def _attn_layout(q: torch.Tensor, k: torch.Tensor):
    """The placements the chunked attention needs of DTensors q and k (v
    as k): ``(q's, k's, k's gradient's)``. None is partial (the softmax is
    not linear); k and v are whole along the sequence (each query row
    reads every key: the sequence gather of sequence parallelism); k and v
    stay sharded on the batch or the heads only on a mesh dim where q is
    sharded alike and their heads divide it (a device's query rows and
    heads read its own keys), else they are gathered there. q keeps its
    batch, sequence and head shards; where q is sharded and k is whole, a
    device's k gradient is its share of a sum (``Partial``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    qp = [p if isinstance(p, Shard) and p.dim % 4 in (0, 1, 2)
          else Replicate() for p in q.placements]
    kp = [p if (isinstance(p, Shard) and p.dim % 4 in (0, 2)
                and qp[i] == p and k.shape[p.dim % 4] % mesh.size(i) == 0)
          else Replicate() for i, p in enumerate(k.placements)]
    gp = [Partial() if isinstance(a, Replicate) and isinstance(b, Shard)
          else a for a, b in zip(kp, qp)]
    return qp, kp, gp


def _from_local(t: torch.Tensor, mesh, placements, shape) -> torch.Tensor:
    """Local shard ``t`` as a DTensor of global ``shape`` on
    ``placements``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _mesh_index(mesh, dims) -> int:
    """This rank's shard index over mesh dims ``dims``, nested in mesh-dim
    order (DTensor's order)."""
    coord = mesh.get_coordinate()
    index = 0
    for i in dims:
        index = index * mesh.size(i) + coord[i]
    return index


def attention_on_shards(fn, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, causal: bool):
    """An attention forward of real DTensors q, k and v run on their local
    shards: q, k and v are redistributed to :func:`_attn_layout`'s
    placements (the layout the meta trace records), ``fn(q_l, k_l, v_l)``
    (the kernel on CUDA shards, the plain version on CPU ones; the output
    ``out_l`` or ``(out_l, lse_l)``) runs on the local tensors, and its
    results are wrapped as DTensors on q's placements. The way through
    is differentiable: the local backward's k and v gradients are each
    device's share of a sum (``Partial``) where q is sharded and k is
    whole. Where q's heads are sharded on a mesh dim whose k heads are
    whole, a device's k and v are cut to the KV heads its query heads
    read (GQA: head ``h`` reads ``h // G``). A causal query sharded on the
    sequence would need a position offset the kernel does not take, and
    raises."""
    from torch.distributed.tensor import Shard
    mesh = q.device_mesh
    qp, kp, gp = _attn_layout(q, k)
    if causal and any(isinstance(p, Shard) and p.dim % 4 == 1 for p in qp):
        raise ValueError("causal attention on a sequence-sharded query "
                         "needs a query position offset, which neither the "
                         "kernel nor its plain version takes")
    b, sq, h, _ = q.shape
    kh, dv = k.shape[2], v.shape[-1]
    q_heads = [i for i, p in enumerate(qp)
               if isinstance(p, Shard) and p.dim % 4 == 2]
    k_heads = [i for i, p in enumerate(kp)
               if isinstance(p, Shard) and p.dim % 4 == 2]
    if k_heads and k_heads != q_heads:
        raise ValueError(f"k heads sharded on mesh dims {k_heads}, q heads "
                         f"on {q_heads}")
    ql = _placed(q, qp).to_local().contiguous()
    kl = _placed(k, kp).to_local(grad_placements=gp)
    vl = _placed(v, kp).to_local(grad_placements=gp)
    if q_heads and not k_heads:
        h_l = h // math.prod(mesh.size(i) for i in q_heads)
        first = _mesh_index(mesh, q_heads) * h_l
        lo, hi = first * kh // h, (first + h_l - 1) * kh // h + 1
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    res = fn(ql, kl.contiguous(), vl.contiguous())
    out = _from_local(res[0] if isinstance(res, tuple) else res, mesh, qp,
                      (b, sq, h, dv))
    if not isinstance(res, tuple):
        return out
    return out, _from_local(res[1], mesh, qp, (b, sq, h))


def _local_dims(x: torch.Tensor, placements=None):
    """The shape of one device's shard of ``x`` on ``placements`` (its
    own when None; rank 0's, the largest, where a dim does not divide),
    without moving it; a plain tensor's own shape."""
    if not _is_dtensor(x):
        return tuple(x.shape)
    from torch.distributed.tensor import Shard
    shape = list(x.shape)
    for i, p in enumerate(x.placements if placements is None
                          else placements):
        if isinstance(p, Shard):
            d = p.dim % len(shape)
            shape[d] = -(-shape[d] // x.device_mesh.size(i))
    return tuple(shape)


def _meta_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_chunk: int = 0, kv_chunk: int = 0):
    """``(out [B, Sq, H, Dv], lse [B, Sq, H])`` of meta inputs: empty. On
    DTensors, q, k and v are first redistributed to
    :func:`_attn_layout`'s placements, so a trace records the collectives
    the plain path implies, and the outputs are placed like that q. The
    call counts by declaration on the shards it runs on."""
    dv = v.shape[-1]
    if _is_dtensor(q):
        qp, kp, _ = _attn_layout(q, k)
        q, k, v = _placed(q, qp), _placed(k, kp), _placed(v, kp)
    declare_attention(_local_dims(q), _local_dims(k), dv, q.element_size(),
                      q_chunk, kv_chunk, False)
    out = torch.empty_like(q if dv == q.shape[-1] else q[..., :dv])
    return out, torch.empty_like(q[..., 0], dtype=torch.float32)


def _meta_empty(shape, dtype, mesh, placements) -> torch.Tensor:
    """An empty meta DTensor of global ``shape`` on ``placements`` (a
    ``Partial`` holds a whole-size share); the local shard is rank 0's,
    the fake world's rank."""
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            d = p.dim % len(local)
            local[d] = -(-local[d] // mesh.size(i))
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device="meta"), mesh, placements,
        run_check=False, shape=torch.Size(shape),
        stride=_contiguous_stride(shape))


def _meta_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, q_chunk: int = 0, kv_chunk: int = 0):
    """``(dq, dk, dv)`` of meta inputs: empty, shaped and placed like q, k
    and v. On DTensors the output's gradient ``do`` is first placed like
    the forward's q, and each gradient is formed on :func:`_attn_layout`'s
    placements and redistributed back to its input's (the transpose of
    :func:`_meta_fwd`'s gathers: a partial k gradient is reduced). The
    call counts by declaration on the forward's shards."""
    if not _is_dtensor(q):
        declare_attention(tuple(q.shape), tuple(k.shape), v.shape[-1],
                          q.element_size(), q_chunk, kv_chunk, True)
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    qp, kp, gp = _attn_layout(q, k)
    declare_attention(_local_dims(q, qp), _local_dims(k, kp), v.shape[-1],
                      q.element_size(), q_chunk, kv_chunk, True)
    _placed(do, qp)
    return tuple(
        _grad_placed(_meta_empty(x.shape, x.dtype, x.device_mesh, p), x)
        for x, p in ((q, qp), (k, gp), (v, gp)))


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

    On ``meta`` tensors (the placement session's DTensor trace) it returns
    empty outputs and computes nothing, as XLA's lowering on host devices
    computes nothing; DTensor inputs are first redistributed as the plain
    path needs them (:func:`_meta_fwd`). Real DTensors are redistributed
    the same way and computed on each device's local shards
    (:func:`attention_on_shards`). On every device the call counts
    on an op-cost recorder by declaration, as the kernel it stands for
    (``kernels/cost_sites.py``), and its ops are not counted.
    """
    if q.device.type == "meta":
        return _meta_fwd(q, k, v, q_chunk, kv_chunk)
    if _is_dtensor(q):
        return attention_on_shards(
            lambda a, b, c: flash_attention_fwd(a, b, c, causal, q_chunk,
                                                kv_chunk), q, k, v, causal)
    declare_attention(tuple(q.shape), tuple(k.shape), v.shape[-1],
                      q.element_size(), q_chunk, kv_chunk, False)
    with opaque():
        return _plain_fwd(q, k, v, causal, q_chunk, kv_chunk)


def _plain_fwd(q, k, v, causal, q_chunk, kv_chunk):
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
    On ``meta`` tensors it returns empty gradients like q, k and v, with
    the reductions the plain path implies on DTensors (:func:`_meta_bwd`).
    On every device it counts by declaration, as the forward does.
    """
    if q.device.type == "meta":
        return _meta_bwd(q, k, v, do, q_chunk, kv_chunk)
    declare_attention(tuple(q.shape), tuple(k.shape), v.shape[-1],
                      q.element_size(), q_chunk, kv_chunk, True)
    with opaque():
        return _plain_bwd(q, k, v, out, lse, do, causal, q_chunk, kv_chunk)


def _plain_bwd(q, k, v, out, lse, do, causal, q_chunk, kv_chunk):
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


def _nll_layout(logits: torch.Tensor):
    """``(logits', rows', vocab dims)``: the placements the chunked loss
    needs of DTensor logits (none partial: the log-sum-exp is not linear),
    those of its per-token rows (the logits' batch and sequence shards,
    whole over the vocab) and the mesh dims that shard the vocab."""
    from torch.distributed.tensor import Replicate, Shard
    nd = logits.dim()
    lp = [Replicate() if p.is_partial() else p for p in logits.placements]
    vocab = [i for i, p in enumerate(lp)
             if isinstance(p, Shard) and p.dim % nd == nd - 1]
    rows = [Replicate() if i in vocab else p for i, p in enumerate(lp)]
    return lp, rows, vocab


def _meta_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The per-token loss of meta logits: empty, float32, shaped like the
    labels. On DTensors, logits and labels are first redistributed as the
    plain path needs them (:func:`_nll_layout`), and where the vocab is
    sharded the three per-token reductions of a vocab-parallel loss are
    recorded: the row max (``Partial("max")``), the sum of exponentials
    and the gold logit (each device holds its vocab slice's share)."""
    if not _is_dtensor(logits):
        declare_token_nll(tuple(logits.shape), logits.element_size(), False)
        return torch.empty(labels.shape, dtype=torch.float32, device="meta")
    from torch.distributed.tensor import Partial
    mesh = logits.device_mesh
    lp, rows, vocab = _nll_layout(logits)
    declare_token_nll(_local_dims(_placed(logits, lp)),
                      logits.element_size(), False)
    labels = _placed(labels, rows)
    for op in ("max", "sum", "sum"):
        _placed(_meta_empty(labels.shape, torch.float32, mesh,
                            [Partial(op) if i in vocab else p
                             for i, p in enumerate(rows)]), rows)
    return torch.empty_like(labels, dtype=torch.float32)


def _meta_nll_grad(logits: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The logits' gradient of :func:`_meta_nll`: empty, placed like the
    logits. On DTensors the incoming gradient is first placed like the
    per-token rows; each device then forms its own vocab slice's gradient
    (the log-sum-exp is whole on every device), which is redistributed to
    the logits' own placements."""
    if not _is_dtensor(logits):
        declare_token_nll(tuple(logits.shape), logits.element_size(), True)
        return torch.empty_like(logits)
    lp, rows, _ = _nll_layout(logits)
    declare_token_nll(_local_dims(logits, lp), logits.element_size(), True)
    _placed(g, rows)
    return _grad_placed(_meta_empty(logits.shape, logits.dtype,
                                    logits.device_mesh, lp), logits)


class _TokenNLL(torch.autograd.Function):
    """``nll[t] = logsumexp(x[t]) - x[t, label[t]]`` in float32 over row
    chunks of the logits. Autograd through the whole-tensor expression
    keeps a float32 copy of the logits for its backward and makes two more
    (the softmax and the scattered gold term): 10 GB each at 4 x 4,096
    tokens of a 151,936-word vocabulary. This keeps the logits in their own
    type and recomputes each chunk's float32 rows in the backward, with the
    same operations autograd would run: ``g * exp(x - lse)``, then ``-g``
    added at the gold column.

    Real DTensor logits reach it as local shards (:func:`token_nll`).
    On ``meta`` tensors (the placement session's DTensor trace) both
    directions return empty results and compute nothing: the loop's row
    slices and its gold gather over a vocab-sharded DTensor cannot be
    traced on meta tensors (DTensor's masked-gather reduction compares
    buffers with ``aten::equal``, which has no meta kernel). On DTensors
    they record the collectives the plain path implies
    (:func:`_meta_nll`). On every device both directions count on an
    op-cost recorder by declaration (``kernels/cost_sites.token_nll_cost``),
    and their ops are not counted."""

    @staticmethod
    def forward(ctx, logits, labels):
        if logits.device.type == "meta":
            ctx.save_for_backward(logits)
            return _meta_nll(logits, labels)
        declare_token_nll(tuple(logits.shape), logits.element_size(), False)
        with opaque():
            x = logits.reshape(-1, logits.shape[-1])
            lab = labels.reshape(-1, 1).long()
            lse = torch.empty(x.shape[0], dtype=torch.float32,
                              device=x.device)
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
        if g.device.type == "meta":
            return _meta_nll_grad(ctx.saved_tensors[0], g), None
        logits, lab, lse = ctx.saved_tensors
        declare_token_nll(tuple(logits.shape), logits.element_size(), True)
        with opaque():
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


class _VocabParallelNLL(torch.autograd.Function):
    """:class:`_TokenNLL` of one device's vocab slice ``x [N, V_l]``
    (columns ``[off, off + V_l)`` of the vocab) of logits whose vocab is
    sharded over the mesh dims ``vocab``: the row max, the sum of
    exponentials and the gold logit are each reduced over those dims'
    process groups (the three per-token reductions the meta trace
    records), so every device holds each row's whole log-sum-exp; the
    backward forms the device's own slice of the gradient from it, with
    no collective."""

    @staticmethod
    def forward(ctx, x, lab, mesh, vocab):
        import torch.distributed as dist

        def reduce(t, op):
            for i in vocab:
                dist.all_reduce(t, op=op, group=mesh.get_group(i))
            return t
        n, v_l = x.shape
        off = _mesh_index(mesh, vocab) * v_l
        local = lab.long() - off
        hit = (local >= 0) & (local < v_l)
        local = local.clamp(0, v_l - 1)[:, None]
        f32 = torch.float32
        m = torch.empty(n, dtype=f32, device=x.device)
        for r in range(0, n, CE_ROWS):
            m[r:r + CE_ROWS] = x[r:r + CE_ROWS].to(f32).amax(dim=-1)
        m = reduce(m, dist.ReduceOp.MAX)
        s = torch.empty_like(m)
        gold = torch.empty_like(m)
        for r in range(0, n, CE_ROWS):
            xf = x[r:r + CE_ROWS].to(f32)
            s[r:r + CE_ROWS] = torch.exp(xf - m[r:r + CE_ROWS, None]).sum(-1)
            gold[r:r + CE_ROWS] = torch.take_along_dim(
                xf, local[r:r + CE_ROWS], dim=-1)[:, 0]
        s = reduce(s, dist.ReduceOp.SUM)
        gold = reduce(torch.where(hit, gold, 0.0), dist.ReduceOp.SUM)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, local, hit, lse)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        x, local, hit, lse = ctx.saved_tensors
        declare_token_nll(tuple(x.shape), x.element_size(), True)
        with opaque():
            g = g.reshape(-1, 1).to(torch.float32)
            gold = torch.where(hit[:, None], -g, 0.0)
            grad = torch.empty_like(x)
            for r in range(0, x.shape[0], CE_ROWS):
                rows = slice(r, r + CE_ROWS)
                gx = g[rows] * torch.exp(x[rows].to(torch.float32)
                                         - lse[rows, None])
                gx.scatter_add_(-1, local[rows], gold[rows])
                grad[rows] = gx.to(grad.dtype)
        return grad, None, None, None


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token ``logsumexp(x) - x[label]`` in float32 (``_TokenNLL``).
    Real DTensor logits are first placed as :func:`_nll_layout` says (the
    labels on the rows' placements), the loss is taken on the local shards
    (over a sharded vocab by :class:`_VocabParallelNLL`), and the per-token
    result is a DTensor on the rows' placements; the way through is
    differentiable. Plain and ``meta`` tensors go to ``_TokenNLL`` as they
    are."""
    if not _is_dtensor(logits) or logits.device.type == "meta":
        return _TokenNLL.apply(logits, labels)
    from repro_torch.dist.sharding import _as_dtensor
    mesh = logits.device_mesh
    lp, rows, vocab = _nll_layout(logits)
    x = _placed(logits, lp).to_local()
    lab = _placed(_as_dtensor(labels, mesh), rows).to_local()
    if vocab:
        declare_token_nll(tuple(x.shape), x.element_size(), False)
        with opaque():
            nll = _VocabParallelNLL.apply(
                x.reshape(-1, x.shape[-1]), lab.reshape(-1), mesh, vocab)
        nll = nll.reshape(lab.shape)
    else:
        nll = _TokenNLL.apply(x, lab)
    return _from_local(nll, mesh, rows, labels.shape)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over (masked) tokens; logits [.., V], labels [..] int. The
    reference's float32 ``logsumexp - gold`` per token, taken over row
    chunks (``_TokenNLL``) so the float32 logits are never whole."""
    nll = token_nll(logits, labels)
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
