"""Port parity for the attention forward: the port's chunked
``flash_attention`` (the CUDA kernel's plain version) against the
reference's Pallas ``flash_attention_fwd`` in interpret mode, its pure-JAX
``_flash`` forward (``models.common.flash_attention``) and the quadratic
``attention_ref``, on the same numpy inputs; plus the dispatch of
``ops.flash_attention`` and the kernel's work count.

The oracle's causal mask is bottom-right aligned and the flash forward's
top-left, so the two are compared only where ``Sq == Sk``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd
from repro.models import common as jcommon
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import common as tcommon

torch.set_num_threads(1)

# tests/test_flash_kernel.py's CASES: (b, sq, sk, h, kh, d, causal, bq, bk)
KERNEL_CASES = [
    (2, 64, 64, 4, 2, 32, True, 16, 16),
    (1, 100, 100, 4, 1, 16, True, 32, 32),     # ragged + MQA
    (2, 64, 64, 8, 8, 32, False, 64, 16),      # MHA bidirectional
    (1, 128, 128, 4, 2, 64, True, 128, 64),    # single q block
]
# tests/test_flash_attention.py's CASES: (b, sq, sk, h, kh, d, dv, causal,
# qc, kc), and two with Sq != Sk (top-left causal, against _flash only)
FLASH_CASES = [
    (2, 64, 64, 4, 4, 32, 32, True, 16, 16),      # MHA
    (2, 64, 64, 8, 2, 32, 32, True, 32, 16),      # GQA
    (1, 100, 100, 4, 1, 16, 16, True, 32, 64),    # MQA, ragged sizes
    (2, 33, 33, 4, 2, 24, 16, True, 16, 8),       # MLA-like dv != d
    (2, 64, 64, 4, 4, 32, 32, False, 16, 16),     # bidirectional
    (2, 64, 64, 4, 2, 32, 32, True, 0, 0),        # unchunked path
    (1, 40, 72, 4, 2, 16, 16, True, 16, 32),      # Sq < Sk
    (1, 72, 40, 4, 2, 16, 16, True, 32, 16),      # Sq > Sk
]
# float32: the reference's own band (tests/test_flash_kernel.py); the two
# frameworks sum the same float32 products in other orders
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16: the reference's band for its bf16 kernel against the oracle
BF16_ATOL = 3e-2


def _qkv(seed, b, sq, sk, h, kh, d, dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kh, dv or d)).astype(np.float32)
    return q, k, v


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=[str(c[:7]) for c in KERNEL_CASES])
def test_plain_matches_pallas_kernel_in_interpret_mode(case):
    b, sq, sk, h, kh, d, causal, bq, bk = case
    q, k, v = _qkv(sum(case[:6]), b, sq, sk, h, kh, d)
    want = flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=bq,
                               block_k=bk, interpret=True)
    got = tcommon.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  q_chunk=bq, kv_chunk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # and the port's oracle (Sq == Sk here)
    ref = tcommon.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **F32_TOL)


def test_plain_bf16_matches_pallas_kernel_and_oracle():
    """tests/test_flash_kernel.py's bf16 case: the same bf16 inputs."""
    q, k, v = _qkv(1, 1, 64, 64, 4, 2, 32)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = flash_attention_fwd(jq, jk, jv, interpret=True)
    tq, tk, tv = (torch.from_numpy(_np(x)).to(torch.bfloat16)
                  for x in (jq, jk, jv))
    got = tcommon.flash_attention(tq, tk, tv, q_chunk=128, kv_chunk=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=BF16_ATOL)
    ref = jcommon.attention_ref(jq, jk, jv)
    np.testing.assert_allclose(got.float().numpy(), _np(ref),
                               atol=BF16_ATOL)
    tref = tcommon.attention_ref(tq, tk, tv)
    np.testing.assert_allclose(tref.float().numpy(), _np(ref),
                               atol=BF16_ATOL)


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[str(c) for c in FLASH_CASES])
def test_plain_matches_jax_flash(case):
    b, sq, sk, h, kh, d, dv, causal, qc, kc = case
    q, k, v = _qkv(sum(case[:5]), b, sq, sk, h, kh, d, dv)
    want = jcommon.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   q_chunk=qc, kv_chunk=kc)
    got = tcommon.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  q_chunk=qc, kv_chunk=kc)
    assert got.shape == (b, sq, h, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    if sq == sk:
        ref = jcommon.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_oracle_matches_reference_oracle_at_any_lengths(causal):
    """attention_ref is copied as-is, bottom-right mask included."""
    q, k, v = _qkv(7, 2, 24, 40, 4, 2, 16)
    want = jcommon.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal)
    got = tcommon.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 48, 48, 4, 2, 16))
    before = tfa.launches
    got = ops.flash_attention(q, k, v, causal=True, q_chunk=16, kv_chunk=32)
    want = tcommon.flash_attention(q, k, v, causal=True, q_chunk=16,
                                   kv_chunk=32)
    assert torch.equal(got, want)
    assert tfa.launches == before
    assert ops.launch_counts()["flash_attention"] == before


def test_work_counts_the_prefill_call():
    """The LM prefill call (4 x 4,096 tokens, 12 heads on 2, D = 128,
    causal, bf16): ~206 GFLOP of visible (query, key) pairs and ~117 MB of
    q, k, v and o."""
    nbytes, flops = tfa.work(4, 4096, 4096, 12, 2, 128, True, 2)
    assert flops == 4.0 * 4 * 12 * 128 * (4096 * 4097 // 2)
    assert round(flops / 1e9) == 206
    assert nbytes == 2 * (2 * 4 * 4096 * 12 * 128 + 2 * 4 * 4096 * 2 * 128)
    assert round(nbytes / 1e6) == 117
    _, dense = tfa.work(1, 10, 6, 2, 1, 4, False, 4)
    assert dense == 4.0 * 2 * 4 * 60


def test_work_counts_the_mla_prefill_call():
    """DeepSeek-V2-Lite's MLA prefill call (4 x 4,096 tokens, 16 heads on
    16, D = 192, Dv = 128, causal, bf16): QK^T over 192 dims and PV over
    128, 343.7 GFLOP (0.3475 ms at the bf16 dense peak of 989 TFLOP/s) and
    336 MB of q, k, v and o."""
    nbytes, flops = tfa.work(4, 4096, 4096, 16, 16, 192, True, 2, dv=128)
    assert flops == 2.0 * 4 * 16 * (4096 * 4097 // 2) * (192 + 128)
    assert round(flops / 1e9, 1) == 343.7
    assert round(flops / 989e12 * 1e3, 4) == 0.3475
    assert nbytes == 2 * (4 * 4096 * 16 * 320 + 4 * 4096 * 16 * 320)
    assert round(nbytes / 1e6) == 336
    assert tfa.work(2, 9, 9, 4, 2, 16, False, 4) == tfa.work(
        2, 9, 9, 4, 2, 16, False, 4, dv=16)
