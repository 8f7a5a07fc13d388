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
outputs of the right shapes and computes nothing. On every device a
call counts on an op-cost recorder by declaration
(``kernels/cost_sites.attention_cost``), the same for the kernel (a launch
the recorder cannot see) and the plain version, whose ops are not
counted. The wrapper's
``q_chunk`` / ``kv_chunk`` are its chunk sizes and do not change the
kernel's own tiling. The launch (kernel, grid, threads, shared memory) comes
from :func:`plan` (``kernels/plan.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build, cost_sites
from repro_torch.kernels import plan as plan_lib
from repro_torch.models.common import flash_attention_bwd as plain_bwd
from repro_torch.models.common import flash_attention_fwd as plain_fwd

# launches of the CUDA kernel (plain CPU calls do not count)
launches = 0

MAX_HEAD_DIM = 192          # q and k
MAX_V_HEAD_DIM = 128        # v and the output
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (D, Dv) pairs the bf16 Hopper (TMA + wgmma) kernel takes
TMA_HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
# the SIMT kernel: 64 q rows and 64 keys a tile, 256 threads
# (__launch_bounds__(256, 2)), transposed tiles of leading dimension 68;
# its padded widths
SIMT_BQ, SIMT_BK, SIMT_LD, SIMT_THREADS = 64, 64, 68, 256
SIMT_DM = (32, 64, 128, 192)
SIMT_DVM = (32, 64, 128)
# the Hopper kernel: 128 q rows and 128 keys a tile, 384 threads (a
# producer warpgroup and two consumers, __launch_bounds__(384, 1))
WG_BQ, WG_BK, WG_THREADS = 128, 128, 384

_plans = plan_lib.cache("flash_attention")


def simt_smem(dm: int) -> int:
    """The SIMT kernel's dynamic shared memory at padded width ``dm``."""
    return 4 * (2 * dm * SIMT_LD + SIMT_BK * SIMT_LD + 4 * SIMT_BQ * 2
                + 2 * SIMT_BQ)


def wgmma_smem(d: int, dv: int) -> int:
    """The Hopper kernel's dynamic shared memory (``WgTile::SMEM``): Q, a
    ring of K and V stages, their barriers and 1 KB of alignment slack."""
    stages = 4 if d == 64 else 2
    panel = WG_BQ * 128
    return (d // 64 * panel + stages * (d // 64 + dv // 64) * panel
            + 8 * (2 + 4 * stages) + 1024)


def plan(b: int, sq: int, sk: int, h: int, kh: int, d: int, dv: int,
         dtype: torch.dtype, lse: bool = False,
         device=None) -> plan_lib.LaunchPlan:
    """The launch for q ``[b, sq, h, d]``, k ``[b, sk, kh, d]`` and v
    ``[b, sk, kh, dv]`` of ``dtype`` (with the ``[b, sq, h]`` log-sum-exp
    where ``lse``) on ``device``'s card, cached by shape: bf16 at a
    ``TMA_HEAD_DIMS`` pair runs the Hopper kernel on a persistent grid of
    ``min(tiles, SMs)`` blocks; everything else the SIMT kernel, a block a
    (batch, head, 64-row q tile)."""
    return _plans.get_or_build(
        (b, sq, sk, h, kh, d, dv, dtype, lse, device),
        lambda: _plan(b, sq, sk, h, kh, d, dv, dtype, lse,
                      plan_lib.device_model(device)))


def _plan(b, sq, sk, h, kh, d, dv, dtype, lse, model):
    dt = "bfloat16" if dtype == torch.bfloat16 else "float32"
    n_bh = b * h
    group = h // kh
    wg = dtype == torch.bfloat16 and (d, dv) in TMA_HEAD_DIMS
    bq = WG_BQ if wg else SIMT_BQ
    n_qtiles = -(-sq // bq)
    tiles = n_bh * n_qtiles

    def work_tile(i):
        bb, hh = divmod(i % n_bh, h)
        return bb, hh, (n_qtiles - 1 - i // n_bh) * bq

    if wg:
        grid = min(tiles, model.sms)
        dm, dvm = d, dv

        def tiles_of(c):
            # snake order: rounds of `grid` tiles, walked back and forth
            out, r = [], 0
            while True:
                i = r * grid + ((grid - 1 - c) if r & 1 else c)
                if i >= tiles:
                    return out
                out.append(work_tile(i))
                r += 1
        kernel = f"flash_fwd_wgmma_kernel<{d},{dv}>"
        threads, smem, min_blocks = WG_THREADS, wgmma_smem(d, dv), 1
        itemsize = 2
        tma = (plan_lib.TensorMap("q", dt, (d, h, sq, b),
                                  (2 * d, 2 * d * h, 2 * d * h * sq),
                                  (64, 1, WG_BQ, 1), 128),
               plan_lib.TensorMap("k", dt, (d, kh, sk, b),
                                  (2 * d, 2 * d * kh, 2 * d * kh * sk),
                                  (64, 1, WG_BK, 1), 128),
               plan_lib.TensorMap("v", dt, (dv, kh, sk, b),
                                  (2 * dv, 2 * dv * kh, 2 * dv * kh * sk),
                                  (64, 1, WG_BK, 1), 128))
    else:
        grid = tiles
        dm = next(x for x in SIMT_DM if x >= max(d, dv))
        dvm = next(x for x in SIMT_DVM if x >= dv)

        def tiles_of(x):
            return [work_tile(x)]
        kernel = (f"flash_fwd_kernel<{'bf16' if dt == 'bfloat16' else 'float'}"
                  f",{dm},{dvm}>")
        threads, smem, min_blocks = SIMT_THREADS, simt_smem(dm), 2
        itemsize = 4 if dt == "float32" else 2
        tma = ()

    def o_tiles(x):
        return [((bb, bb + 1), (q0, q0 + bq), (hh, hh + 1), (0, dv))
                for bb, hh, q0 in tiles_of(x)]

    def lse_tiles(x):
        return [((bb, bb + 1), (q0, q0 + bq), (hh, hh + 1))
                for bb, hh, q0 in tiles_of(x)]

    def q_reads(x):
        return [((bb, bb + 1), (q0, min(sq, q0 + bq)), (hh, hh + 1), (0, d))
                for bb, hh, q0 in tiles_of(x)]

    def kv_reads(width):
        return lambda x: [((bb, bb + 1), (0, sk), (hh // group,
                                                  hh // group + 1),
                           (0, width)) for bb, hh, _ in tiles_of(x)]

    arg = plan_lib.Arg
    outputs = (arg("out", (b, sq, h, dv), dt),)
    writes = (o_tiles,)
    masked = ((False, True, False, False),)
    if lse:
        outputs += (arg("lse", (b, sq, h), "float32"),)
        writes += (lse_tiles,)
        masked += ((False, True, False),)
    return plan_lib.LaunchPlan(
        name="flash_attention", entry="flash_attention", kernel=kernel,
        grid=(grid,), threads=(threads,), dyn_smem=smem,
        smem_optin=smem > 48 * 1024, min_blocks_per_sm=min_blocks,
        operands=(arg("q", (b, sq, h, d), dt), arg("k", (b, sk, kh, d), dt),
                  arg("v", (b, sk, kh, dv), dt)),
        outputs=outputs, writes=writes,
        reads=(q_reads, kv_reads(d), kv_reads(dv)), masked_edges=masked,
        tma=tma, vectors=(("q", itemsize * d * h, 0),) if wg else (),
        args={"path": "wgmma" if wg else "simt", "code": int(wg),
              "dm": dm, "dvm": dvm})


def example_plans():
    """The reference's example (``b=1, sq=sk=256, h=2, kh=1, d=128``, in
    float32: the SIMT kernel), then the Hopper kernel at (64, 64), (128,
    128) and (192, 128), and float32 with the log-sum-exp."""
    return [plan(1, 256, 256, 2, 1, 128, 128, torch.float32),
            plan(1, 256, 256, 2, 1, 64, 64, torch.bfloat16),
            plan(1, 256, 256, 2, 1, 128, 128, torch.bfloat16),
            plan(1, 256, 256, 2, 1, 192, 128, torch.bfloat16, lse=True),
            plan(1, 200, 200, 4, 2, 40, 24, torch.float32, lse=True)]


def launch(p: plan_lib.LaunchPlan, q, k, v, out, lse, causal: bool,
           stream=None) -> None:
    """One launch of ``p`` on the wrapper's checked tensors (``lse`` None
    or the ``[B, Sq, H]`` buffer)."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    fn = build.entry("flash_attention", [ctypes.c_void_p] * 5
                     + [ctypes.c_int] * 9
                     + [ctypes.c_float] + [ctypes.c_int] * 3
                     + build.LAUNCH_ARGTYPES)
    build.check("flash_attention", fn(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
        None if lse is None else build.ptr(lse), b, sq, sk, h, kh, d,
        v.shape[-1], _DTYPES[q.dtype], int(bool(causal)),
        float(1.0 / np.sqrt(d)), p.args["code"], p.args["dm"], p.args["dvm"],
        *p.launch_dims(),
        build.stream_of(q.device) if stream is None else stream))


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
    cost_sites.declare_attention((b, sq, h, d), (b, sk, kh, d), dv,
                                 q.element_size(), q_chunk, kv_chunk, False)
    p = (plan(b, sq, sk, h, kh, d, dv, q.dtype, return_lse, dev)
         if b and sq else None)
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev)
    lse = (torch.empty((b, sq, h), dtype=torch.float32, device=dev)
           if return_lse else None)
    if p is None:
        return (out, lse) if return_lse else out
    launch(p, q, k, v, out, lse, causal)
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
