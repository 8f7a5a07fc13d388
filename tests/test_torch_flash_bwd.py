"""Port parity for the attention's training path: the plain forward's
log-sum-exp against the reference's ``_flash_fwd_impl``, and the
``FlashAttention`` function's dq/dk/dv (the plain ``_flash_bwd`` recompute)
against ``jax.vjp`` of the reference's ``flash_attention`` (its
``custom_vjp``), at every case of ``tests/test_flash_attention.py``'s
``CASES`` and two with Sq != Sk, float32, from the same numpy inputs.
Plus the dispatch: where autograd records, ``ops.flash_attention`` goes
through the Function, and under ``torch.no_grad`` it is the forward
alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import common as tcommon

torch.set_num_threads(1)

# (b, sq, sk, h, kh, d, dv, causal, qc, kc): tests/test_flash_attention.py's
# CASES, then two with Sq != Sk (the top-left causal mask)
CASES = [
    (2, 64, 64, 4, 4, 32, 32, True, 16, 16),      # MHA
    (2, 64, 64, 8, 2, 32, 32, True, 32, 16),      # GQA
    (1, 100, 100, 4, 1, 16, 16, True, 32, 64),    # MQA, ragged sizes
    (2, 33, 33, 4, 2, 24, 16, True, 16, 8),       # MLA-like dv != d
    (2, 64, 64, 4, 4, 32, 32, False, 16, 16),     # bidirectional
    (2, 64, 64, 4, 2, 32, 32, True, 0, 0),        # unchunked path
    (1, 40, 72, 4, 2, 16, 16, True, 16, 32),      # Sq < Sk
    (1, 72, 40, 4, 2, 16, 16, True, 32, 16),      # Sq > Sk
]
# float32: the reference's band for its kernel (tests/test_flash_kernel.py);
# the two frameworks sum the same float32 products in other orders
TOL = dict(rtol=2e-5, atol=2e-5)
IDS = ["x".join(map(str, c)) for c in CASES]


def _inputs(case, seed):
    b, sq, sk, h, kh, d, dv, _, _, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kh, d)).astype(np.float32),
            rng.standard_normal((b, sk, kh, dv)).astype(np.float32),
            rng.standard_normal((b, sq, h, dv)).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_lse_matches_flash_fwd_impl(case):
    b, sq, sk, h, kh, d, dv, causal, qc, kc = case
    q, k, v, _ = _inputs(case, 1)
    want_out, want_lse = jcommon._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, qc, kc)
    out, lse = tcommon.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_chunk=qc, kv_chunk=kc)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, sq, h)
    # the reference's [B, Sq, Kh, G] is the same memory as [B, Sq, H]
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(
        b, sq, h), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    # the wrapper hands back the plain version's pair on CPU tensors
    out2, lse2 = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_chunk=qc, kv_chunk=kc, return_lse=True)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_function_grads_match_reference_vjp(case):
    _, _, _, _, _, _, _, causal, qc, kc = case
    q, k, v, do = _inputs(case, 2)

    def f(q, k, v):
        return jcommon.flash_attention(q, k, v, causal=causal, q_chunk=qc,
                                       kv_chunk=kc)
    want_out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, q_chunk=qc,
                              kv_chunk=kc)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **TOL)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", CASES[:4], ids=IDS[:4])
def test_bwd_equals_the_reference_bwd_on_its_own_residuals(case):
    """``flash_attention_bwd`` against ``_flash_bwd`` fed the same (q, k, v,
    out, lse, do): the backward alone, apart from the forward."""
    b, sq, sk, h, kh, d, dv, causal, qc, kc = case
    q, k, v, do = _inputs(case, 3)
    out, lse = jcommon._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal, qc, kc)
    want = jcommon._flash_bwd(causal, qc, kc, (jnp.asarray(q), jnp.asarray(
        k), jnp.asarray(v), out, lse), jnp.asarray(do))
    got = tcommon.flash_attention_bwd(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, out)),
        torch.from_numpy(np.array(lse)).reshape(b, sq, h),
        torch.from_numpy(do), causal=causal, q_chunk=qc, kv_chunk=kc)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_bwd_rejects_a_shifted_lse():
    """The saved lse matters: lse + ln 2 halves every P, and the gradients
    move far outside the band (the planted fault of the card's gate (a))."""
    case = CASES[1]
    b, sq, sk, h, kh, d, dv, causal, qc, kc = case
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(case, 4))
    out, lse = tcommon.flash_attention_fwd(q, k, v, causal, qc, kc)
    good = tcommon.flash_attention_bwd(q, k, v, out, lse, do, causal, qc, kc)
    bad = tcommon.flash_attention_bwd(q, k, v, out, lse + np.log(2.0), do,
                                      causal, qc, kc)
    for g, w in zip(bad, good):
        assert float((g - w).abs().max()) > 100 * TOL["atol"]


def test_no_grad_calls_skip_the_function_and_the_lse(monkeypatch):
    """Prefill and serving (``torch.no_grad``) call the forward without
    ``return_lse``; a recorded call asks for it once, through the
    Function."""
    seen = []
    real = tfa.flash_attention

    def spy(*args, **kw):
        seen.append(kw.get("return_lse", False))
        return real(*args, **kw)
    monkeypatch.setattr(tfa, "flash_attention", spy)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(CASES[1], 5))
    with torch.no_grad():
        out = ops.flash_attention(q.requires_grad_(True), k, v)
    assert out.grad_fn is None and seen == [False]
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is not None and seen == [False, True]
    out = ops.flash_attention(q.detach(), k, v)       # nothing to record
    assert out.grad_fn is None and seen == [False, True, False]
