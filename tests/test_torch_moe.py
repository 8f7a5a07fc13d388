"""Port parity for the MoE FFN (``models.transformer.moe_ffn``): the
reference's sort-based capacity dispatch on the same numpy inputs at both
DeepSeek-V2 SMOKE configs, with the reference's weights carried across by
``interop.transformer_params_from``; the dispatch (stable sort, positions,
the dropped set) against ``jnp.argsort`` on the same expert ids; the
combine's single float32 rounding in bf16; the aux loss and drop share."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist.sharding import lm_rules
from repro.models import transformer as jtr
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import transformer as ttr

torch.set_num_threads(1)
RULES = lm_rules(())
NAMES = ["deepseek-v2-lite-16b", "deepseek-v2-236b"]
# float32 outputs: the same float32 products summed in other orders
Y_TOL = 1e-5
AUX_RTOL = 1e-6
# the reference's bf16 band for a weighted sum of bf16 rows
# (tests/test_kernels.py, bag_combine in bf16: rtol = atol = 5e-2)
BF16_BAND = 5e-2


@functools.lru_cache(maxsize=None)
def _moe_layer(name):
    """(reference cfg, numpy params of the first MoE layer, port params)."""
    cfg = jconfigs.get(name).smoke_config()
    params, _ = jtr.init(jax.random.PRNGKey(0), cfg, RULES)
    params = jax.tree.map(np.asarray, params)
    port = interop.transformer_params_from(params)
    jp = jax.tree.map(lambda x: x[0], params["moe_layers"]["ffn"])
    return cfg, jp, port["layers"][cfg.n_dense_layers]["ffn"]


def _x(t, d, seed):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(
        np.float32)


def _reference_dispatch(x, jp, jcfg, cap):
    """The reference's routing and dispatch lines (``moe_ffn``) on its own
    weights: (top_i, order, pos, valid, slot) as numpy."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, jcfg.top_k)
    flat_e = top_i.reshape(-1).astype(jnp.int32)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(jcfg.n_experts,
                                                   dtype=jnp.int32))
    pos = jnp.arange(flat_e.shape[0], dtype=jnp.int32) - starts[sorted_e]
    valid = pos < cap
    slot = jnp.where(valid, sorted_e * cap + pos, jcfg.n_experts * cap)
    return tuple(np.asarray(a) for a in (top_i, order, pos, valid, slot))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("capacity_factor", [None, 0.5],
                         ids=["config", "dropping"])
def test_moe_ffn_matches_reference(name, capacity_factor):
    """Expert ids, the dropped set and ``dropped_frac`` exactly, aux within
    rel 1e-6, y within 1e-5; at capacity 0.5 pairs are dropped."""
    jcfg, jp, tp = _moe_layer(name)
    cfg = tconfigs.get(name).smoke_config()
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    t = 40
    x = _x(t, cfg.d_model, seed=len(name))
    want_y, want = jtr.moe_ffn(jp, jnp.asarray(x), jcfg, RULES)
    got_y, got = ttr.moe_ffn(tp, torch.from_numpy(x), cfg)
    cap = ttr.capacity(cfg, t)
    top_i, order, pos, valid, slot = _reference_dispatch(x, jp, jcfg, cap)
    _, _, g_top_i = ttr.route(tp, torch.from_numpy(x), cfg)
    g_order, _, _, g_pos, g_valid, g_slot = ttr.dispatch(g_top_i,
                                                         cfg.n_experts, cap)
    np.testing.assert_array_equal(g_top_i.numpy(), top_i)
    np.testing.assert_array_equal(g_order.numpy(), order)
    np.testing.assert_array_equal(g_pos.numpy(), pos)
    np.testing.assert_array_equal(g_valid.numpy(), valid)
    np.testing.assert_array_equal(g_slot.numpy(), slot)
    if capacity_factor is not None:
        assert not valid.all()
    assert float(got.dropped_frac) == float(want.dropped_frac)
    assert float(got.dropped_frac) == pytest.approx(1.0 - valid.mean(),
                                                    abs=1e-7)
    assert abs(float(got.aux_loss) - float(want.aux_loss)) <= \
        AUX_RTOL * abs(float(want.aux_loss))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=Y_TOL,
                               atol=Y_TOL)


@pytest.mark.parametrize("n,e,k,cap", [(64, 8, 2, 8), (200, 16, 6, 24),
                                       (7, 64, 6, 8), (300, 4, 1, 40)])
def test_dispatch_matches_jnp_argsort_on_tied_ids(n, e, k, cap):
    """Many equal ids: the port's stable sort, positions, dropped set and
    slots equal the reference's ``jnp.argsort`` dispatch, pair for pair;
    ``starts`` counts each expert's pairs."""
    rng = np.random.default_rng(n + e)
    top_i = np.stack([rng.permutation(e)[:k] for _ in range(n)]).astype(
        np.int32)
    flat = jnp.asarray(top_i.reshape(-1))
    order = jnp.argsort(flat)
    sorted_e = flat[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(e, dtype=jnp.int32))
    pos = jnp.arange(n * k, dtype=jnp.int32) - starts[sorted_e]
    got = ttr.dispatch(torch.from_numpy(top_i), e, cap)
    for a, b in zip(got, (order, sorted_e, starts, pos, pos < cap,
                          jnp.where(pos < cap, sorted_e * cap + pos,
                                    e * cap))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_combine_rounds_the_float32_sum_once_in_bf16():
    """bf16 weighted rows: the combine is their float32 sum over k rounded
    once to bf16 (within one bf16 ulp of numpy's float64-ordered float32
    sum), and within the reference's bf16 band of its ``segment_sum``,
    which rounds after each add in bf16."""
    t, k, d = 50, 6, 64
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.standard_normal((t * k, d)).astype(
        np.float32)).to(torch.bfloat16)
    order = torch.from_numpy(rng.permutation(t * k))
    got = ttr.combine(rows, order, t, k)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (t, d)
    flat = np.empty((t * k, d), np.float32)
    flat[order.numpy()] = rows.float().numpy()
    want = torch.from_numpy(flat.reshape(t, k, d).sum(axis=1)).to(
        torch.bfloat16).float()
    err = (got.float() - want).abs()
    ulp = torch.ldexp(torch.ones_like(err), torch.frexp(want)[1] - 8)
    assert bool((err <= ulp).all()), float((err / ulp).max())
    ref = jax.ops.segment_sum(
        jnp.asarray(rows.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(order.numpy() // k), num_segments=t)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=BF16_BAND,
                               atol=BF16_BAND)


@pytest.mark.parametrize("name", NAMES)
def test_moe_ffn_in_bf16_within_the_reference_band(name):
    """The whole FFN in bf16 (weights cast on both sides) against the
    reference's bf16 ``moe_ffn`` within its bf16 band, with the same
    experts chosen (the router stays float32)."""
    jcfg, jp, tp = _moe_layer(name)
    cfg = dataclasses.replace(tconfigs.get(name).smoke_config(),
                              dtype=torch.bfloat16)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    x = torch.from_numpy(_x(32, cfg.d_model, seed=5)).to(torch.bfloat16)
    jp16 = {kk: (v if kk == "router" else jnp.asarray(v).astype(
        jnp.bfloat16)) for kk, v in jp.items()}
    tp16 = {kk: (v if kk == "router" else v.to(torch.bfloat16))
            for kk, v in tp.items()}
    want, _ = jtr.moe_ffn(jp16, jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16), jcfg, RULES)
    got, _ = ttr.moe_ffn(tp16, x, cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=BF16_BAND,
                               atol=BF16_BAND)
    assert torch.equal(ttr.moe_ffn(tp16, x, cfg)[0], got)


def test_moe_stats_count_every_pair():
    """``dropped_frac`` is the share of pairs past their expert's
    capacity; ``aux`` is ``E * sum(me * ce) * coef`` with ``ce`` the pair
    counts over ``T k``."""
    name = NAMES[0]
    _, _, tp = _moe_layer(name)
    cfg = dataclasses.replace(tconfigs.get(name).smoke_config(),
                              capacity_factor=0.25)
    x = torch.from_numpy(_x(64, cfg.d_model, seed=9))
    _, stats = ttr.moe_ffn(tp, x, cfg)
    probs, _, top_i = ttr.route(tp, x, cfg)
    counts = np.bincount(top_i.numpy().reshape(-1),
                         minlength=cfg.n_experts)
    cap = ttr.capacity(cfg, 64)
    kept = np.minimum(counts, cap).sum()
    assert float(stats.dropped_frac) == pytest.approx(
        1.0 - kept / counts.sum(), abs=1e-7)
    ce = counts / counts.sum()
    aux = cfg.n_experts * float((probs.mean(0).numpy() * ce).sum()) \
        * cfg.aux_loss_coef
    assert float(stats.aux_loss) == pytest.approx(aux, rel=1e-6)


def test_ep_shard_map_falls_through_to_the_local_path():
    """One card has no mesh: ``ep_shard_map`` computes what the local path
    does, as the reference does without a ``model`` axis."""
    name = NAMES[1]
    _, _, tp = _moe_layer(name)
    cfg = tconfigs.get(name).smoke_config()
    x = torch.from_numpy(_x(24, cfg.d_model, seed=2))
    a, sa = ttr.moe_ffn(tp, x, cfg)
    b, sb = ttr.moe_ffn(tp, x, dataclasses.replace(cfg, ep_shard_map=True))
    assert torch.equal(a, b) and torch.equal(sa.aux_loss, sb.aux_loss)


@pytest.mark.parametrize("name", NAMES)
def test_capacity_matches_reference(name):
    cfg = tconfigs.get(name).make_config("decode_32k")
    for t in (1, 4, 64, 256, 16384):
        cap = int(np.ceil(cfg.capacity_factor * t * cfg.top_k
                          / cfg.n_experts))
        assert ttr.capacity(cfg, t) == max(8, (cap + 7) // 8 * 8)
    # 4 x 4,096 tokens at the lite config's 1.5: 2,304 slots an expert
    if name == "deepseek-v2-lite-16b":
        assert ttr.capacity(cfg, 4 * 4096) == 2304
