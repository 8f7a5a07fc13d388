"""Online-softmax attention forward with GQA (``ops.flash_attention``).

Replaces the Pallas kernel
``repro/kernels/flash_attention.py:flash_attention_fwd`` with
``csrc/flash_attention.cu``. On the model path it stands where the
reference's pure-JAX ``_flash`` forward runs (``models/common.py``), which
computes the same function: every layer of the LM's ``forward`` /
``prefill`` (``models/transformer.gqa_attention``).

q ``[B, Sq, H, D]``, k ``[B, Sk, KH, D]`` and v ``[B, Sk, KH, Dv]`` in
float32 or bf16 with ``D <= 192`` and ``Dv <= 128`` (MLA prefill: D =
192, Dv = 128; the dense LMs: Dv = D); causal masking is top-left aligned
(``k_pos <= q_pos``) as in the TPU kernel. One CUDA block per (batch,
head, q tile) walks the kv tiles with the running max, sum and
accumulator in float32 and writes its output once: deterministic, no
atomics. At the LM's prefill shape the call is bound by operations at the
bf16 tensor-core peak (~0.21 ms on an H100 for Qwen2-1.5B, ~0.35 ms for
DeepSeek-V2-Lite's MLA). bf16 with ``(D, Dv)`` of (64, 64), (128, 128) or
(192, 128) (the LM paths) runs a Hopper kernel: one persistent block per
SM walks 128-row q tiles, longest first; a producer warp streams Q, K and
V tiles by TMA through ``mbarrier``s into a ring of shared-memory stages,
and two consumer warpgroups take turns multiplying with ``wgmma`` (128
keys a tile), each running its softmax while the tensor cores work on the
other's products and its own P V. TMA reads 16-byte-aligned bases only,
so that path raises on a misaligned q, k or v (a contiguous view at an
odd element offset). float32 and other head dims run a SIMT float32
kernel (``PERF.md`` has both against the bound).

With ``return_lse=True`` the kernel also writes each row's log-sum-exp
of the scaled scores (float32 ``[B, Sq, H]``), the residual the backward
recomputes P from; a null pointer skips that store, so the serving and
prefill calls, which do not ask for it, launch what they did before and
the output is bitwise the same either way. :class:`FlashAttention` is the
``torch.autograd.Function`` of the training path (the twin of the
reference's ``jax.custom_vjp`` around ``_flash``): its forward is this
wrapper with ``lse`` (the kernel on CUDA tensors), its backward the plain
``_flash_bwd`` recompute (``models.common.flash_attention_bwd``) on either
device. :func:`attention` goes through it where a gradient is wanted.

The plain version is the chunked twin of ``_flash_fwd_impl``
(``models.common.flash_attention_fwd``); CPU tensors run it, and so do
``meta`` tensors (the placement session's trace), for which it returns
outputs of the right shapes and computes nothing. The wrapper's
``q_chunk`` / ``kv_chunk`` are its chunk sizes and do not change the
kernel's own tiling.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.models.common import flash_attention_bwd as plain_bwd
from repro_torch.models.common import flash_attention_fwd as plain_fwd

# launches of the CUDA kernel (plain CPU calls do not count)
launches = 0

MAX_HEAD_DIM = 192          # q and k
MAX_V_HEAD_DIM = 128        # v and the output
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (D, Dv) pairs the bf16 Hopper (TMA + wgmma) kernel takes
TMA_HEAD_DIMS = ((64, 64), (128, 128), (192, 128))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 512, return_lse: bool = False):
    """``[B, Sq, H, D]`` x ``[B, Sk, KH, D]`` x ``[B, Sk, KH, Dv]`` ->
    ``[B, Sq, H, Dv]`` in q's dtype, and with ``return_lse`` also the
    float32 ``[B, Sq, H]`` log-sum-exp, as ``(out, lse)``: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    global launches
    dev = q.device
    if dev.type in ("cpu", "meta"):
        out, lse = plain_fwd(q, k, v, causal=causal, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)
        return (out, lse) if return_lse else out
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k and v must be 4-d, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    dv = v.shape[-1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} (float32 or "
                        f"bfloat16)")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} outside [1, "
                         f"{MAX_HEAD_DIM}]")
    if not 1 <= dv <= MAX_V_HEAD_DIM:
        raise ValueError(f"flash_attention: value head dim {dv} outside "
                         f"[1, {MAX_V_HEAD_DIM}]")
    if kh < 1 or h % kh:
        raise ValueError(f"flash_attention: {h} query heads on {kh} KV "
                         f"heads")
    build.require(q, "flash_attention q", q.dtype, dev, (b, sq, h, d))
    build.require(k, "flash_attention k", q.dtype, dev, (b, sk, kh, d))
    build.require(v, "flash_attention v", q.dtype, dev, (b, sk, kh, dv))
    if q.dtype == torch.bfloat16 and (d, dv) in TMA_HEAD_DIMS:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention {name}: base pointer not "
                                 f"16-byte aligned (TMA reads aligned "
                                 f"bases only)")
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev)
    lse = (torch.empty((b, sq, h), dtype=torch.float32, device=dev)
           if return_lse else None)
    if b == 0 or sq == 0:
        return (out, lse) if return_lse else out
    fn = build.entry("flash_attention", [ctypes.c_void_p] * 5
                     + [ctypes.c_int] * 9
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    build.check("flash_attention", fn(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
        None if lse is None else build.ptr(lse), b, sq, sk, h, kh, d, dv,
        _DTYPES[q.dtype], int(bool(causal)), float(1.0 / np.sqrt(d)),
        build.sm_count(dev), build.stream_of(dev)))
    launches += 1
    return (out, lse) if return_lse else out


def kernel_fwd(q, k, v, causal, q_chunk, kv_chunk):
    """``(out, lse)`` of :func:`flash_attention`: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    return flash_attention(q, k, v, causal, q_chunk, kv_chunk,
                           return_lse=True)


class FlashAttention(torch.autograd.Function):
    """Attention with the reference's custom VJP. ``apply(q, k, v, causal,
    q_chunk, kv_chunk, fwd)``: the forward is ``fwd``, ``kernel_fwd`` (one
    kernel launch on CUDA tensors) or ``plain_fwd`` (the plain version on
    either device, the path the card's checks compare with), saving ``(q,
    k, v, out, lse)``; the backward is the plain ``_flash_bwd`` recompute,
    which launches no kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk, fwd):
        out, lse = fwd(q, k, v, causal, q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.chunking = (causal, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = plain_bwd(q, k, v, out, lse, do, *ctx.chunking)
        return dq, dk, dv, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, q_chunk: int = 512,
              kv_chunk: int = 512) -> torch.Tensor:
    """The model's attention: through :class:`FlashAttention` where autograd
    records (grad mode on and an input that requires grad), else the
    forward alone without ``lse`` (prefill and serving under
    ``torch.no_grad``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, q_chunk, kv_chunk,
                                    kernel_fwd)
    return flash_attention(q, k, v, causal, q_chunk, kv_chunk)


def work(b: int, sq: int, sk: int, h: int, kh: int, d: int, causal: bool,
         itemsize: int, dv: Optional[int] = None):
    """(bytes, flops) the call needs: q, k, v read once and o written once;
    one multiply-add per visible (query, key) and q/k dim (QK^T) and one
    per visible (query, key) and v dim (PV), counting only the keys the
    top-left causal mask leaves visible. ``dv`` defaults to ``d``."""
    dv = d if dv is None else dv
    rows = np.arange(sq, dtype=np.int64)
    visible = int(np.minimum(rows + 1, sk).sum()) if causal else sq * sk
    flops = 2.0 * b * h * visible * (d + dv)
    bytes_moved = itemsize * (b * sq * h * (d + dv) + b * sk * kh * (d + dv))
    return float(bytes_moved), flops
