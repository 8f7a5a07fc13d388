"""Port parity for MLA (DeepSeek-V2's multi-head latent attention):
``mla_attention`` (prefill through ``flash_attention`` at D = dn + dr, Dv =
dv), ``init_cache`` and the absorbed ``_decode_attn_mla`` against
``repro.models.transformer`` at both DeepSeek-V2 SMOKE configs (without
and with ``q_lora_rank``), with the reference's weights carried across by
``interop.transformer_params_from``, all on the same numpy inputs; within
the port, prefill against stepped decode under a capacity that drops no
pair, and the absorbed decode against one that materialises ``k_nope`` and
``v`` from the same cache."""
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist.sharding import lm_rules
from repro.models import common as jcommon
from repro.models import transformer as jtr
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttr

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import materialised_mla_decode  # noqa: E402  (the smoke's)

torch.set_num_threads(1)
RULES = lm_rules(())
NAMES = ["deepseek-v2-lite-16b", "deepseek-v2-236b"]
# float32 at smoke width: the same products summed in other orders
TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _params(name):
    """(reference cfg, numpy params, port cfg, port params)."""
    jcfg = jconfigs.get(name).smoke_config()
    params, _ = jtr.init(jax.random.PRNGKey(1), jcfg, RULES)
    params = jax.tree.map(np.asarray, params)
    return (jcfg, params, tconfigs.get(name).smoke_config(),
            interop.transformer_params_from(params))


def _attn(name):
    jcfg, params, cfg, port = _params(name)
    stack = "dense_layers"
    return (jcfg, jax.tree.map(lambda x: x[0], params[stack]["attn"]), cfg,
            port["layers"][0]["attn"])


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("chunks", [(512, 512), (8, 4)],
                         ids=["whole", "small"])
def test_mla_attention_matches_reference(name, chunks):
    """Prefill MLA, the attention over [nope | rope] dims with v of its own
    head dim; the small chunks walk several q and kv chunks."""
    jcfg, jp, cfg, tp = _attn(name)
    jcfg = dataclasses.replace(jcfg, q_chunk=chunks[0], kv_chunk=chunks[1])
    cfg = dataclasses.replace(cfg, q_chunk=chunks[0], kv_chunk=chunks[1])
    assert bool(cfg.q_lora_rank) == (name == "deepseek-v2-236b")
    b, s = 2, 19
    x = _x(b, s, cfg.d_model, seed=1)
    angles = jcommon.rope_freqs(jcfg.qk_rope_head_dim, s, jcfg.rope_theta)
    want = jtr.mla_attention(jp, jnp.asarray(x), jcfg, RULES, angles)
    tables = ttr._rope_tables(tcommon.rope_freqs(cfg.rope_dim, s,
                                                 cfg.rope_theta), cfg)
    seen = []

    def attend(q, k, v, **kw):
        seen.append((q.shape, k.shape, v.shape, q.is_contiguous(),
                     k.is_contiguous(), v.is_contiguous()))
        return tcommon.flash_attention(q, k, v, **kw)
    got = ttr.mla_attention(tp, torch.from_numpy(x), cfg, tables, attend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    h = cfg.n_heads
    assert seen == [((b, s, h, qk), (b, s, h, qk), (b, s, h, cfg.v_head_dim),
                     True, True, True)]


@pytest.mark.parametrize("name", NAMES)
def test_init_cache_matches_reference(name):
    jcfg, _, cfg, _ = _params(name)
    want, _ = jtr.init_cache(jcfg, 3, 11, RULES)
    got = ttr.init_cache(cfg, 3, 11, device="cpu")
    assert got.keys() == want.keys() == {"c_kv", "k_rope"}
    for key in got:
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == torch.float32 and not got[key].any()


@pytest.mark.parametrize("name", NAMES)
def test_decode_attn_mla_matches_reference(name):
    """The absorbed decode at every position of a 7-token cache: the
    output and both caches (written in place here, returned by the
    reference)."""
    jcfg, jp, cfg, tp = _attn(name)
    b, t = 2, 7
    xs = _x(b, t, cfg.d_model, seed=2)
    angles = jcommon.rope_freqs(jcfg.qk_rope_head_dim, t, jcfg.rope_theta)
    jcache, _ = jtr.init_cache(jcfg, b, t, RULES)
    jc = {k: v[0] for k, v in jcache.items()}
    cache = ttr.init_cache(cfg, b, t, device="cpu")
    t_angles = tcommon.rope_freqs(cfg.rope_dim, t, cfg.rope_theta)
    for pos in range(t):
        x = xs[:, pos:pos + 1]
        want, jc = jtr._decode_attn_mla(jp, jnp.asarray(x), jc,
                                        jnp.int32(pos), jcfg, RULES, angles)
        tables = ttr._rope_tables(t_angles[pos:pos + 1], cfg)
        mask = torch.arange(t) <= pos
        got = ttr._decode_attn_mla(tp, torch.from_numpy(x),
                                   cache["c_kv"][0], cache["k_rope"][0], pos,
                                   cfg, tables, mask)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for key in ("c_kv", "k_rope"):
            np.testing.assert_allclose(cache[key][0].numpy(),
                                       np.asarray(jc[key]), **TOL)


def _no_drop(cfg):
    """The config at capacity factor E / k: every expert has a slot for
    every token, so no pair is dropped at any token count."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def _record_stats(monkeypatch):
    stats = []
    inner = ttr.moe_ffn

    def moe_ffn(p, x, cfg, *rules):
        y, st = inner(p, x, cfg, *rules)
        stats.append(float(st.dropped_frac))
        return y, st
    monkeypatch.setattr(ttr, "moe_ffn", moe_ffn)
    return stats


@pytest.mark.parametrize("name", NAMES)
def test_prefill_equals_stepped_decode_without_drops(name, monkeypatch):
    """Prefill's logits at every position against the absorbed decode
    stepping the same tokens, at a capacity that drops nothing in either
    (prefill's T = B S tokens and decode's B differ in capacity, so at
    the config's factor they would drop different pairs)."""
    _, _, cfg, params = _params(name)
    cfg = _no_drop(cfg)
    b, t = 2, 12
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (b, t)))
    stats = _record_stats(monkeypatch)
    full = ttr.prefill(params, toks, cfg)
    cache = ttr.init_cache(cfg, b, t, device="cpu")
    for pos in range(t):
        step, cache = ttr.decode_step(params, cache, toks[:, pos:pos + 1],
                                      pos, cfg)
        scale = float(full[:, pos].abs().max())
        err = (step - full[:, pos]).abs()
        assert bool((err <= 2e-5 * (scale + full[:, pos].abs())).all()), \
            float(err.max())
    n_moe = cfg.n_layers - cfg.n_dense_layers
    assert len(stats) == n_moe * (1 + t) and not any(stats)


@pytest.mark.parametrize("name", NAMES)
def test_absorbed_decode_equals_materialised(name):
    """Folding W_uk into the query and W_uv after the context is the same
    function as attending over materialised k_nope / v (the smoke run's
    second correct decode for its check (d))."""
    _, _, cfg, params = _params(name)
    tp = params["layers"][0]["attn"]
    b, t = 2, 9
    xs = torch.from_numpy(_x(b, t, cfg.d_model, seed=6))
    angles = tcommon.rope_freqs(cfg.rope_dim, t, cfg.rope_theta)
    caches = [ttr.init_cache(cfg, b, t, device="cpu") for _ in range(2)]
    for pos in range(t):
        tables = ttr._rope_tables(angles[pos:pos + 1], cfg)
        mask = torch.arange(t) <= pos
        outs = [fn(tp, xs[:, pos:pos + 1], c["c_kv"][0], c["k_rope"][0], pos,
                   cfg, tables, mask)
                for fn, c in zip((ttr._decode_attn_mla,
                                  materialised_mla_decode), caches)]
        torch.testing.assert_close(outs[0], outs[1], **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_params_from_unstack_dense_then_moe_layers(name):
    """``transformer_params_from`` unstacks ``dense_layers`` then
    ``moe_layers``, every MLA and MoE key, and maps any tree of the
    params' structure (here zeros) the same way."""
    jcfg, params, cfg, port = _params(name)
    assert len(port["layers"]) == cfg.n_layers
    for li, layer in enumerate(port["layers"]):
        stack = ("moe_layers" if cfg.moe_layer(li) else "dense_layers")
        at = li - (cfg.n_dense_layers if cfg.moe_layer(li) else 0)
        for part in ("attn", "ffn"):
            assert layer[part].keys() == params[stack][part].keys()
            for key, x in layer[part].items():
                np.testing.assert_array_equal(x.numpy(),
                                              params[stack][part][key][at])
    zeros = interop.transformer_params_from(jax.tree.map(np.zeros_like,
                                                         params))
    for a, z in zip(port["layers"], zeros["layers"]):
        assert a["ffn"].keys() == z["ffn"].keys()
        assert all(not v.any() for v in z["ffn"].values())
