"""Kernel sites that count by declaration on an op-cost recorder.

A hand-written kernel's launch is invisible to a ``TorchDispatchMode``,
and on ``meta`` tensors (the placement session's trace) the plain version
it stands for computes nothing; so the attention and the token loss
declare what one device's call costs, with one rule on every device, and
run their plain ops :func:`opaque` (not counted). The recorder itself is
``launch/op_cost.OpCostRecorder``; it registers in :data:`_ACTIVE` while
it is entered. Without one every hook here is a no-op, so the model and
kernel layers call them unconditionally.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

# the recorders counting now (``launch/op_cost.OpCostRecorder``), innermost
# last; each has ``_declare``, ``_opaque`` and ``_paused``
_ACTIVE: List[Any] = []


def declare(site: str, cost: Dict[str, float]) -> None:
    """Count a kernel site by declaration on every active recorder (a
    no-op with none): ``cost`` as :func:`attention_cost` and
    :func:`token_nll_cost` give it, its ``flops`` and ``transcendentals``
    as they are, its ``bytes`` (of which ``f32_bytes`` are float32) as a
    custom kernel's I/O, under ``bytes``, ``bytes_fused`` and
    ``bytes_tight``."""
    for rec in _ACTIVE:
        rec._declare(site, cost)


@contextlib.contextmanager
def opaque() -> Iterator[None]:
    """The ops run inside are not counted (a declared kernel site's plain
    version); the memory they allocate is still tracked."""
    for rec in _ACTIVE:
        rec._opaque += 1
    try:
        yield
    finally:
        for rec in _ACTIVE:
            rec._opaque = max(rec._opaque - 1, 0)


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """Nothing run inside is seen, neither counted nor tracked (a
    recorder's own bookkeeping)."""
    for rec in _ACTIVE:
        rec._paused += 1
    try:
        yield
    finally:
        for rec in _ACTIVE:
            rec._paused = max(rec._paused - 1, 0)


def attention_cost(b: int, sq: int, sk: int, h: int, kh: int, d: int,
                   dv: int, itemsize: int, q_chunk: int, kv_chunk: int,
                   backward: bool = False) -> Dict[str, float]:
    """One device's attention call, as the reference's HLO counts
    ``_flash`` (``src/repro/models/common.py``): the products over every
    (query, key) pair of every kv chunk, padded keys and masked ones
    included, and the elementwise ops the online softmax runs on each
    score, each row and each output element. The per-score and per-row
    constants are fitted to ``hlo_cost.analyze`` of the reference's
    ``_flash_fwd`` / ``_flash_bwd`` compiled alone (float32 and bf16, one
    to four kv chunks, D = Dv and D > Dv; ``tests/test_torch_dryrun.py``
    holds them within 2.5% / 3.5%): the forward's products, about 10
    elementwise ops a score (2 more in bf16: the converts), 4·Dv a row
    and kv chunk for the running rescale where the kv loop is a loop, 3·Dv
    a row for the output; the backward's products count 6·D + 4·Dv a
    score (the scores again, dq and dk over D; dp and dv over Dv), then
    about 7 ops a score (14 in bf16) and 8·(D + Dv) a row. The exps:
    one a score, one a row and kv chunk and the log-sum-exp's log a row in
    the forward (the first chunk's rescale folds away when there is one
    chunk); one a score in the backward. The bytes are the fused
    kernel's: q, k, v read and o written, twice more in the backward (the
    reference's ``attention_kernel_bytes``)."""
    q_chunk = min(q_chunk or sq, sq)
    kv_chunk = min(kv_chunk or sk, sk)
    nq = -(-sq // q_chunk)
    nk = -(-sk // kv_chunk)
    rows = float(b) * nq * q_chunk * h          # padded query rows
    keys = float(nk) * kv_chunk                 # padded keys
    scores = rows * keys
    conv = 1.0 if itemsize != 4 else 0.0        # P / ds rounded to bf16
    io = float(itemsize) * (b * sq * h * (d + dv) + b * sk * kh * (d + dv))
    f32 = io if itemsize == 4 else 0.0
    if not backward:
        loop = rows * nk if nk > 1 else 0.0
        flops = (scores * (2.0 * (d + dv) + 10.0 + 2.0 * conv)
                 + loop * 4.0 * dv + rows * 3.0 * dv)
        return {"flops": flops, "transcendentals": scores + loop + rows,
                "bytes": io, "f32_bytes": f32}
    flops = (scores * (6.0 * d + 4.0 * dv + 7.0 + 7.0 * conv)
             + rows * 8.0 * (d + dv))
    return {"flops": flops, "transcendentals": scores, "bytes": 2.0 * io,
            "f32_bytes": 2.0 * f32}


def token_nll_cost(tokens: int, vocab: int, itemsize: int,
                   backward: bool = False) -> Dict[str, float]:
    """One device's token loss over ``[tokens, vocab]`` logits, as the
    reference's HLO counts the per-token loss of ``cross_entropy``:
    ``hlo_cost.analyze`` of the loss compiled alone, and of the loss and
    its VJP compiled as one program (a train step) less that forward
    (``tests/test_torch_dryrun.py`` holds both within 1%, float32 and
    bf16). The forward: the row max, the subtract, the exp and the sum
    over every logit, XLA's split row reductions (1/16 an element), 3 more
    a logit in bf16 (the converts), 13 a token; one exp a logit and the
    log a token; tight bytes 12.5 a logit (the two reductions' and the
    gold gather's float32 operands) and 20 a token, all float32 but the
    labels' 8. The backward reuses the forward's exps: one product a logit
    (7 in bf16: the converts and the subtract again) and 14 a token, no
    transcendental; the gold term's scatter, 8 tight float32 bytes a logit
    (its operand and result) and 12 a token, 4 of them float32."""
    cells = float(tokens) * vocab
    conv = 1.0 if itemsize != 4 else 0.0        # the logits are bf16
    if not backward:
        tight = 12.5 * cells + 20.0 * tokens
        return {"flops": (4.0625 + 3.0 * conv) * cells + 13.0 * tokens,
                "transcendentals": cells + tokens,
                "bytes": tight, "f32_bytes": tight - 8.0 * tokens}
    return {"flops": (1.0 + 6.0 * conv) * cells + 14.0 * tokens,
            "transcendentals": 0.0, "bytes": 8.0 * cells + 12.0 * tokens,
            "f32_bytes": 8.0 * cells + 4.0 * tokens}


def declare_attention(q_shape: Sequence[int], k_shape: Sequence[int],
                      dv: int, itemsize: int, q_chunk: int, kv_chunk: int,
                      backward: bool) -> None:
    """Count one device's attention call (``q [B, Sq, H, D]``, ``k [B, Sk,
    Kh, D]``, values of width ``dv``) on the active recorders."""
    if _ACTIVE:
        b, sq, h, d = q_shape
        _, sk, kh, _ = k_shape
        declare("flash_attention", attention_cost(
            b, sq, sk, h, kh, d, dv, itemsize, q_chunk, kv_chunk, backward))


def declare_token_nll(logits_shape: Sequence[int], itemsize: int,
                      backward: bool) -> None:
    """Count one device's token loss over logits of ``logits_shape`` on
    the active recorders."""
    if _ACTIVE:
        tokens = int(np.prod(logits_shape[:-1]))
        declare("token_nll", token_nll_cost(tokens, int(logits_shape[-1]),
                                            itemsize, backward))
