"""Port parity for the LMs: the LM configs and shape grid, the model
pieces of ``models/common.py``, and ``forward`` / ``prefill`` /
``decode_step`` against ``repro.models.transformer`` on the ``SMOKE``
configs (float32) of the dense GQA ``qwen2-1.5b``, ``chatglm3-6b`` and
``qwen2-72b`` and the MoE + MLA ``deepseek-v2-lite-16b`` and
``deepseek-v2-236b``, with the reference's weights carried across by
``interop.transformer_params_from``, all on the same numpy inputs. The
reference's functions are compiled once per module."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import chatglm3_6b as jglm
from repro.configs import common as jcc
from repro.configs import deepseek_v2_236b as jds
from repro.configs import deepseek_v2_lite_16b as jlite
from repro.configs import qwen2_1_5b as jqwen
from repro.configs import qwen2_72b as jqwen72
from repro.dist.sharding import lm_rules
from repro.models import common as jcommon
from repro.models import transformer as jtr
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.configs import chatglm3_6b as tglm
from repro_torch.configs import common as tcc
from repro_torch.configs import deepseek_v2_236b as tds
from repro_torch.configs import deepseek_v2_lite_16b as tlite
from repro_torch.configs import qwen2_1_5b as tqwen
from repro_torch.configs import qwen2_72b as tqwen72
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttr

torch.set_num_threads(1)
RULES = lm_rules(())
NAMES = ["qwen2-1.5b", "chatglm3-6b", "qwen2-72b", "deepseek-v2-lite-16b",
         "deepseek-v2-236b"]
MODULES = {"qwen2-1.5b": (jqwen, tqwen), "chatglm3-6b": (jglm, tglm),
           "qwen2-72b": (jqwen72, tqwen72),
           "deepseek-v2-lite-16b": (jlite, tlite),
           "deepseek-v2-236b": (jds, tds)}
# float32 logits at smoke width: the same float32 products summed in other
# orders by the two frameworks' GEMMs and attention, over 2 layers; the
# measured worst is 4.9e-7 of the largest logit (~5), so 2e-5 of it (and of
# each value) leaves 40x room
LOGIT_RTOL = 2e-5


def _assert_logits_close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    err = np.abs(got - want)
    assert np.all(err <= LOGIT_RTOL * (scale + np.abs(want))), \
        (float(err.max()), scale)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(cfg, numpy params, jitted forward, jitted decode_step) of the
    reference at SMOKE, built once per arch."""
    cfg = jconfigs.get(name).smoke_config()
    params, _ = jtr.init(jax.random.PRNGKey(0), cfg, RULES)
    fwd = jax.jit(lambda p, t: jtr.forward(p, t, cfg, RULES))
    dec = jax.jit(lambda p, c, t, pos: jtr.decode_step(p, c, t, pos, cfg,
                                                       RULES))
    return cfg, params, fwd, dec


def _port(name):
    cfg = tconfigs.get(name).smoke_config()
    _, params, _, _ = _reference(name)
    return cfg, interop.transformer_params_from(
        jax.tree.map(np.asarray, params))


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def _fields(cfg):
    """The config's fields, its dtype by name (a torch or a JAX dtype)."""
    out = dataclasses.asdict(cfg)
    dt = out["dtype"]
    out["dtype"] = (str(dt).split(".")[-1] if isinstance(dt, torch.dtype)
                    else np.dtype(dt).name)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_arch_configs_match_reference(name):
    j, t = jconfigs.get(name), tconfigs.get(name)
    assert t.name == j.name and t.family == j.family == "lm"
    jm, tm = MODULES[name]
    assert _fields(tm.FULL) == _fields(jm.FULL)
    assert _fields(tm.SMOKE) == _fields(jm.SMOKE)
    assert _fields(t.smoke_config()) == _fields(j.smoke_config())
    for shape in j.shapes:
        assert _fields(t.make_config(shape)) == _fields(j.make_config(shape))
        assert t.model_flops(shape) == j.model_flops(shape)
    assert {k: dataclasses.asdict(v) for k, v in t.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in j.shapes.items()}
    jb, tb = j.smoke_batch(), t.smoke_batch()
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    full = t.make_config("decode_32k")
    assert full.dtype == torch.bfloat16
    assert full.n_params() == j.make_config("decode_32k").n_params()


def test_qwen2_full_size():
    """qwen2-1.5b at full width: 1,777,030,656 parameters, 3.55 GB in
    bf16; 28 layers of 12 query heads on 2 KV heads of 128."""
    cfg = tconfigs.get("qwen2-1.5b").make_config("decode_32k")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (28, 1536, 12, 2, 128,
                                                   8960, 151936)
    assert cfg.n_params() == 1_777_030_656
    assert round(cfg.n_params() * 2 / 1e9, 2) == 3.55
    assert cfg.max_seq == 32768


@pytest.mark.parametrize("full_attention", [True, False])
def test_lm_shape_grid_and_flops_match_reference(full_attention):
    j = jcc.lm_shape_grid(full_attention=full_attention)
    t = tcc.lm_shape_grid(full_attention=full_attention)
    assert list(t) == list(j)
    for name, spec in j.items():
        assert dataclasses.asdict(t[name]) == dataclasses.asdict(spec)
        for n_act in (1, 1_777_030_656):
            assert tcc.lm_model_flops(n_act, t[name]) == \
                jcc.lm_model_flops(n_act, spec)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "deepseek-v2-236b", "qwen2-72b"])
def test_param_counts_match_reference_for_every_kind(name):
    """``TransformerConfig`` keeps the MoE and MLA fields, so the counts
    hold for the archs the port does not run yet."""
    jc = jconfigs.get(name).make_config("train_4k")
    fields = {f.name: getattr(jc, f.name)
              for f in dataclasses.fields(ttr.TransformerConfig)}
    fields["dtype"] = torch.bfloat16
    tc = ttr.TransformerConfig(**fields)
    assert tc.n_params() == jc.n_params()
    assert tc.n_active_params() == jc.n_active_params()
    assert tc.head_dim == jc.head_dim and tc.qk_head_dim == jc.qk_head_dim


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------

def test_norm_swiglu_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    gamma = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma)),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(gamma))),
        rtol=1e-6, atol=1e-6)
    h = rng.standard_normal((4, 8)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32)
          for s in ((8, 12), (8, 12), (12, 8))]
    np.testing.assert_allclose(
        tcommon.swiglu(torch.from_numpy(h), *map(torch.from_numpy, ws)),
        np.asarray(jcommon.swiglu(jnp.asarray(h), *map(jnp.asarray, ws))),
        rtol=1e-5, atol=1e-5)
    ang_t = tcommon.rope_freqs(16, 5, 1e4)
    ang_j = jcommon.rope_freqs(16, 5, 1e4)
    np.testing.assert_array_equal(ang_t.numpy(), np.asarray(ang_j))
    np.testing.assert_allclose(
        tcommon.apply_rope(torch.from_numpy(x), ang_t),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), ang_j)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ttr._partial_rope(torch.from_numpy(x), ang_t, 0.5),
        np.asarray(jtr._partial_rope(jnp.asarray(x), ang_j, 0.5)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_init_has_the_reference_shapes(name):
    cfg = tconfigs.get(name).smoke_config()
    gen = torch.Generator().manual_seed(0)
    got = ttr.init(cfg, gen, device="cpu")
    want = _port(name)[1]
    assert got.keys() == want.keys()
    assert len(got["layers"]) == len(want["layers"]) == cfg.n_layers

    def leaves(p, prefix=""):
        for k, v in p.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v
    for a, b in zip(got["layers"] + [{k: got[k] for k in
                                      ("embed", "unembed", "ln_f")}],
                    want["layers"] + [{k: want[k] for k in
                                       ("embed", "unembed", "ln_f")}]):
        ga, gb = dict(leaves(a)), dict(leaves(b))
        assert ga.keys() == gb.keys()
        for k in ga:
            assert ga[k].shape == gb[k].shape and ga[k].dtype == gb[k].dtype
    layer = got["layers"][0]
    assert torch.equal(layer["ln1"], torch.ones(cfg.d_model))
    if cfg.qkv_bias:
        assert torch.equal(layer["attn"]["b_q"], torch.zeros(
            cfg.n_heads * cfg.head_dim))
    if cfg.moe:
        moe = got["layers"][-1]["ffn"]
        assert moe["router"].dtype == torch.float32
        assert abs(float(moe["w_down"].std()) * np.sqrt(cfg.d_ff_expert)
                   - 1.0) < 0.1
    # scales: embed ~ N(0, 1), projections ~ N(0, 1/d_in)
    assert abs(float(got["embed"].std()) - 1.0) < 0.05
    assert abs(float(layer["ffn"]["w_down"].std()) * np.sqrt(cfg.d_ff)
               - 1.0) < 0.1


def test_deepseek_lite_full_size():
    """deepseek-v2-lite-16b at full width: 15.7B parameters (31.4 GB in
    bf16), 2.7B active a token; 27 layers, the first dense, MLA heads of
    192 (q/k) and 128 (v)."""
    cfg = tconfigs.get("deepseek-v2-lite-16b").make_config("decode_32k")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.qk_head_dim,
            cfg.v_head_dim, cfg.kv_lora_rank, cfg.n_experts,
            cfg.top_k) == (27, 2048, 16, 192, 128, 512, 64, 6)
    assert round(cfg.n_params() / 1e9, 1) == 15.7
    assert round(cfg.n_params() * 2 / 1e9, 1) == 31.4
    assert round(cfg.n_active_params() / 1e9, 1) == 2.7
    assert [cfg.moe_layer(li) for li in range(3)] == [False, True, True]


@pytest.mark.parametrize("kind", ["paged_cache", "paged_decode_step"])
def test_paged_serving_keeps_refusing_mla(kind):
    """The paged server covers the GQA cache layout only: MLA's
    rank-compressed cache has no per-head pages, and both the pool and the
    step refuse it, as the reference's do (``tests/test_serving.py``)."""
    from repro_torch.serving import PagedKVCache
    from repro_torch.serving.paged_decode import paged_decode_step
    cfg = tconfigs.get("deepseek-v2-lite-16b").smoke_config()
    with pytest.raises(NotImplementedError, match="MLA|GQA"):
        if kind == "paged_cache":
            PagedKVCache(8, 4, 2, 4, cfg=cfg, device="cpu")
        else:
            params = ttr.init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
            paged_decode_step(params, torch.zeros(1), torch.zeros(1),
                              torch.zeros((1, 1), dtype=torch.long),
                              torch.zeros(1, dtype=torch.long),
                              torch.zeros((1, 1), dtype=torch.long), cfg)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tconfigs.get("qwen2-1.5b").smoke_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.init(cfg, torch.Generator(), device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.init_cache(cfg, 1, 8)


# ---------------------------------------------------------------------------
# forward / prefill / decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_forward_and_prefill_match_reference(name):
    jcfg, jparams, jfwd, _ = _reference(name)
    cfg, params = _port(name)
    toks = _tokens(cfg.vocab, 2, 24, seed=1)
    want, aux = jfwd(jparams, jnp.asarray(toks))
    got, got_aux = ttr.forward(params, torch.from_numpy(toks), cfg)
    _assert_logits_close(got, want)
    if cfg.moe:
        assert float(aux) > 0.0
        assert abs(float(got_aux) - float(aux)) <= 1e-6 * float(aux)
    else:
        assert float(got_aux) == float(aux) == 0.0
    _assert_logits_close(ttr.prefill(params, torch.from_numpy(toks), cfg),
                         want)


@pytest.mark.parametrize("name", NAMES)
def test_forward_through_small_chunks_matches_reference(name):
    """A sequence longer than the plain flash chunks (several q and kv
    chunks, a ragged last one) — the tiling the reference uses at 4k."""
    jcfg, jparams, _, _ = _reference(name)
    cfg, params = _port(name)
    jcfg = dataclasses.replace(jcfg, q_chunk=16, kv_chunk=8)
    cfg = dataclasses.replace(cfg, q_chunk=16, kv_chunk=8)
    toks = _tokens(cfg.vocab, 1, 37, seed=2)
    want, _ = jtr.forward(jparams, jnp.asarray(toks), jcfg, RULES)
    got, _ = ttr.forward(params, torch.from_numpy(toks), cfg)
    _assert_logits_close(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference(name):
    jcfg, jparams, _, jdec = _reference(name)
    cfg, params = _port(name)
    b, t = 2, 9
    toks = _tokens(cfg.vocab, b, t, seed=3)
    jcache, _ = jtr.init_cache(jcfg, b, t, RULES)
    cache = ttr.init_cache(cfg, b, t, device="cpu")
    for pos in range(t):
        want, jcache = jdec(jparams, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                            jnp.int32(pos))
        got, cache = ttr.decode_step(params, cache,
                                     torch.from_numpy(toks[:, pos:pos + 1]),
                                     pos, cfg)
        _assert_logits_close(got, want)
    assert cache.keys() == jcache.keys()
    for key in cache:
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_equals_stepped_decode(name):
    """Within the port: prefill's logits at every position equal the
    decode steps' over the dense cache (the flash forward against the
    decode's masked softmax; MLA's absorbed decode). The DeepSeek SMOKE
    configs' capacity factor is E / k, so no MoE pair drops in either."""
    cfg, params = _port(name)
    toks = torch.from_numpy(_tokens(cfg.vocab, 2, 16, seed=4))
    full = ttr.prefill(params, toks, cfg)
    cache = ttr.init_cache(cfg, 2, 16, device="cpu")
    for pos in range(16):
        step, cache = ttr.decode_step(params, cache, toks[:, pos:pos + 1],
                                      pos, cfg)
        _assert_logits_close(step, full[:, pos].numpy())
