"""Port parity for LM training: ``lm_batches``, ``loss_fn`` and its
gradients at ``qwen2-1.5b`` SMOKE against ``jax.value_and_grad`` of the
reference's (weights carried across by ``interop``), ``adamw.update``,
``compress.roundtrip`` on the reference's stacked leaves, a 10-step loss
trajectory against the reference's ``make_train_step``, the checkpoint
and loop (twins of ``tests/test_ckpt_and_loop.py``), resume against an
uninterrupted run, and the training CLI. All on the CPU, from numpy
seeds; each tolerance is stated where it is used."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.dist import compress as jcompress
from repro.dist.sharding import lm_rules
from repro.models import common as jmcommon
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch import interop, tree
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data import pipeline as tpipeline
from repro_torch.dist import compress
from repro_torch.launch import train as tlaunch
from repro_torch.models import common as tmcommon
from repro_torch.models import transformer as ttr
from repro_torch.optim import adamw
from repro_torch.train import loop
from repro_torch.train.steps import (loss_and_grads, make_eval_step,
                                     make_train_step)

torch.set_num_threads(1)
ARCH = "qwen2-1.5b"
RULES = lm_rules(())
BATCH, SEQ = 2, 16
# float32 at SMOKE width: the same float32 products summed in other orders
# by the two frameworks over 2 layers and a 512-way softmax; the loss is
# held to 1e-5 relative and each gradient leaf to 1e-4 of its own L2 norm
# (the measured worst leaf is 2.4e-6: 40x room)
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4


@functools.lru_cache(maxsize=None)
def _reference():
    """(cfg, numpy params) of the reference at SMOKE, from PRNGKey(0)."""
    cfg = jconfigs.get(ARCH).smoke_config()
    params, _ = jtr.init(jax.random.PRNGKey(0), cfg, RULES)
    return cfg, jax.tree.map(np.asarray, params)


def _port_params():
    return interop.transformer_params_from(_reference()[1])


def _batches(n, seed=0):
    cfg = _reference()[0]
    gen = jpipeline.lm_batches(cfg.vocab, BATCH, SEQ, seed=seed)
    return [next(gen) for _ in range(n)]


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_tree_close(got, want, rel=GRAD_REL_L2):
    """Port tree ``got`` against the reference tree ``want`` (stacked),
    leaf by leaf after unstacking ``want``."""
    want = interop.transformer_params_from(want)
    for (path, g), w in zip(tree.flatten(got), tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape), path
        assert _rel_l2(g.float().numpy(), w.float().numpy()) <= rel, path


def _grads(params, batch, cfg):
    return loss_and_grads(lambda p, b: ttr.loss_fn(p, b, cfg), params,
                          batch)


# ---------------------------------------------------------------------------
# data, loss, gradients
# ---------------------------------------------------------------------------

def test_lm_batches_equal_the_reference():
    want = jpipeline.lm_batches(512, 3, 33, seed=5)
    got = tpipeline.lm_batches(512, 3, 33, seed=5)
    for _ in range(4):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_loss_and_grads_match_reference():
    cfg, params = _reference()
    batch = _batches(1)[0]
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jtr.loss_fn(p, jax.tree.map(jnp.asarray, batch), cfg,
                              RULES), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tcfg = tconfigs.get(ARCH).smoke_config()
    tloss, taux, tgrads = _grads(_port_params(), _tb(batch), tcfg)
    np.testing.assert_allclose(float(tloss.detach()), float(loss),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(taux["ce"]), float(aux["ce"]),
                               rtol=LOSS_RTOL)
    assert float(taux["aux"]) == float(aux["aux"]) == 0.0
    _assert_tree_close(tgrads, jax.tree.map(np.asarray, grads))


def _whole_tensor_ce(logits, labels, mask):
    """The float32 ``logsumexp - gold`` over the whole logits, through
    autograd: what ``cross_entropy`` computed before it took row chunks."""
    x = logits.to(torch.float32)
    nll = (torch.logsumexp(x, dim=-1)
           - torch.take_along_dim(x, labels.long()[..., None], dim=-1)[..., 0])
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_cross_entropy(monkeypatch, masked, dtype):
    """``cross_entropy`` over 39 rows in chunks of 8 (five chunks, the last
    ragged): its loss and logits gradient are bitwise those of the
    whole-tensor autograd (the same float32 row operations), and within
    float32 rounding (rel 1e-6, and 1e-9 absolute for the gradient's
    entries of a tiny probability) of the reference's ``cross_entropy`` and
    its ``jax.grad`` on the same values; a bf16 gradient within one bf16
    ulp (rel 2^-7), since the two frameworks' float32 ``exp`` round a few
    elements to either side of a bf16 rounding boundary."""
    monkeypatch.setattr(tmcommon, "CE_ROWS", 8)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 3, (3, 13, 50)).astype(np.float32)
                         ).to(dtype)
    labels = torch.from_numpy(rng.integers(0, 50, (3, 13)).astype(np.int32))
    mask = (torch.from_numpy((rng.random((3, 13)) > 0.3).astype(np.float32))
            if masked else None)
    runs = []
    for fn in (tmcommon.cross_entropy, _whole_tensor_ce):
        leaf = x.clone().requires_grad_(True)
        loss = fn(leaf, labels, mask)
        runs.append((loss.detach(), torch.autograd.grad(loss, leaf)[0]))
    (loss, grad), (want_loss, want_grad) = runs
    assert grad.dtype == dtype
    assert torch.equal(loss, want_loss) and torch.equal(grad, want_grad)
    jx = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jloss, jgrad = jax.value_and_grad(jmcommon.cross_entropy)(
        jx, jnp.asarray(labels.numpy()),
        None if mask is None else jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(grad.float().numpy(),
                               np.asarray(jgrad.astype(jnp.float32)),
                               rtol=1e-6 if dtype == torch.float32
                               else 2.0 ** -7,
                               atol=1e-9 if dtype == torch.float32 else 0)


def test_remat_keeps_the_gradients():
    """``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``): the same operations on the same inputs,
    so the loss and every gradient are bitwise those without it."""
    tcfg = tconfigs.get(ARCH).smoke_config()
    batch = _tb(_batches(1)[0])
    runs = [_grads(_port_params(), batch, dataclasses.replace(tcfg,
                                                              remat=remat))
            for remat in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(tree.leaves(runs[0][2]), tree.leaves(runs[1][2])):
        assert torch.equal(a, b)


def test_remat_recomputes_the_attention_forward(monkeypatch):
    """With remat a step runs each layer's attention forward twice (the
    forward and the recompute in the backward); without it once."""
    from repro_torch.kernels import flash_attention as tfa
    calls = []
    real = tfa.kernel_fwd

    def count(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(tfa, "kernel_fwd", count)
    tcfg = tconfigs.get(ARCH).smoke_config()
    batch = _tb(_batches(1)[0])
    for remat, want in ((False, 1), (True, 2)):
        calls.clear()
        _grads(_port_params(), batch, dataclasses.replace(tcfg, remat=remat))
        assert len(calls) == want * tcfg.n_layers


def test_eval_step():
    tcfg = tconfigs.get(ARCH).smoke_config()
    batch = _tb(_batches(1)[0])
    m = make_eval_step(lambda p, b: ttr.loss_fn(p, b, tcfg))(
        _port_params(), batch)
    assert sorted(m) == ["aux", "ce", "loss"] and m["loss"].grad_fn is None
    assert float(m["loss"]) == float(_grads(_port_params(), batch, tcfg)[0])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _noise_tree(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                        .astype(np.float32), params)


@pytest.mark.parametrize("bf16_state", [False, True])
def test_adamw_update_matches_reference(bf16_state):
    """Three updates from the reference's SMOKE params with random
    gradients (the first clipped: its norm is ~500), the learning rate
    past warm-up so every leaf moves by ~lr, and non-zero norms so that
    decay shows; float32 arithmetic in the same order, so 1e-6 of each
    leaf's norm (measured worst 1.4e-7). With bf16 first moments a last-bit
    difference in a float32 moment can round to the next bf16 value (2^-8
    relative) in a few elements: the moments are held to 5e-4 and the
    weights to 2e-5 (measured worst 4.7e-5 and 2.0e-6)."""
    _, params = _reference()
    params = jax.tree.map(lambda p: p + 0.5, params)   # norms 1.5, biases .5
    cfg = jadamw.AdamWConfig(lr=0.05, warmup_steps=1, total_steps=10,
                             bf16_state=bf16_state)
    tcfg = adamw.AdamWConfig(**dataclasses.asdict(cfg))
    jp, jo = jax.tree.map(jnp.asarray, params), jadamw.init(params, cfg)
    tp = interop.transformer_params_from(params)
    to = adamw.init(tp, tcfg)
    assert tree.leaves(to.mu)[0].dtype == (torch.bfloat16 if bf16_state
                                           else torch.float32)
    for i in range(3):
        g = _noise_tree(params, i, scale=10.0 if i == 0 else 0.1)
        jp, jo, jm = jadamw.update(jax.tree.map(jnp.asarray, g), jo, jp, cfg)
        tp, to, tm = adamw.update(interop.transformer_params_from(g), to, tp,
                                  tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(to.step) == int(jo.step) == 3
    _assert_tree_close(tp, jax.tree.map(np.asarray, jp),
                       rel=2e-5 if bf16_state else 1e-6)
    _assert_tree_close(to.mu, jax.tree.map(np.asarray, jo.mu),
                       rel=5e-4 if bf16_state else 1e-6)
    _assert_tree_close(to.nu, jax.tree.map(np.asarray, jo.nu), rel=1e-6)


def test_weight_decay_reaches_every_stacked_leaf():
    """The reference decays leaves of rank >= 2 in its stacked layout, so
    each layer's norms and QKV biases are decayed and only ``ln_f`` is not.
    With zero gradients the update is the decay alone: the port must move
    every per-layer leaf by ``lr * wd * p`` (a port that decayed by its own
    unrolled rank would leave ``ln1``, ``ln2`` and the biases alone) and
    leave ``ln_f``."""
    _, params = _reference()
    params = jax.tree.map(lambda p: p + 0.5, params)
    cfg = jadamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10,
                             min_lr_frac=1.0)
    zeros = jax.tree.map(np.zeros_like, params)
    jp, _, _ = jadamw.update(jax.tree.map(jnp.asarray, zeros),
                             jadamw.init(params, cfg),
                             jax.tree.map(jnp.asarray, params), cfg)
    tp0 = interop.transformer_params_from(params)
    tcfg = adamw.AdamWConfig(**dataclasses.asdict(cfg))
    tp, _, _ = adamw.update(interop.transformer_params_from(zeros),
                            adamw.init(tp0, tcfg), tp0, tcfg)
    _assert_tree_close(tp, jax.tree.map(np.asarray, jp), rel=1e-6)
    for name in ("ln1", "ln2"):
        np.testing.assert_allclose(tp["layers"][1][name].numpy(),
                                   0.99 * tp0["layers"][1][name].numpy(),
                                   rtol=1e-6)
    np.testing.assert_allclose(tp["layers"][0]["attn"]["b_k"].numpy(),
                               0.99 * tp0["layers"][0]["attn"]["b_k"].numpy(),
                               rtol=1e-6)
    assert torch.equal(tp["ln_f"], tp0["ln_f"])


def test_adamw_converges_and_clips():
    ocfg = adamw.AdamWConfig(lr=0.1, total_steps=100, warmup_steps=0,
                             weight_decay=0.0, clip_norm=1.0,
                             min_lr_frac=1.0)   # constant lr for this test
    params = {"x": torch.tensor([10.0, -10.0])}
    opt = adamw.init(params, ocfg)
    for _ in range(100):
        grads = {"x": 2 * params["x"]}
        params, opt, m = adamw.update(grads, opt, params, ocfg)
    assert float(params["x"].abs().max()) < 0.5
    assert float(m["grad_norm"]) >= 0


def test_bf16_optimizer_state():
    ocfg = adamw.AdamWConfig(bf16_state=True, total_steps=10)
    params = {"x": torch.zeros(4, dtype=torch.bfloat16)}
    opt = adamw.init(params, ocfg)
    assert opt.mu["x"].dtype == torch.bfloat16
    assert opt.nu["x"].dtype == torch.float32
    p2, o2, _ = adamw.update({"x": torch.ones(4, dtype=torch.bfloat16)}, opt,
                             params, ocfg)
    assert p2["x"].dtype == torch.bfloat16 and o2.mu["x"].dtype == \
        torch.bfloat16


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------

def _layered_grads(seed):
    """Gradients in the reference's stacked layout whose layers differ in
    scale by 100x, so one scale over the stack and one per layer quantize
    them differently."""
    _, params = _reference()
    rng = np.random.default_rng(seed)

    def leaf(p):
        g = rng.standard_normal(p.shape).astype(np.float32)
        if p.ndim >= 2 and p.shape[0] == 2:            # a stacked leaf
            g[1] *= 0.01
        return g
    return {k: (jax.tree.map(leaf, v) if k == "dense_layers" else leaf(v))
            for k, v in params.items()}


@pytest.mark.parametrize("block", [None, 256])
def test_compress_roundtrip_equals_reference(block):
    """Exact: the same float32 divisions, roundings and products, over the
    reference's stacked leaves; two steps so the residual feeds back."""
    g0, g1 = _layered_grads(0), _layered_grads(1)
    jstate, tstate = None, None
    for g in (g0, g1):
        jout, jstate = jcompress.roundtrip(jax.tree.map(jnp.asarray, g),
                                           jstate, block=block)
        tout, tstate = compress.roundtrip(interop.transformer_params_from(g),
                                          tstate, block=block)
        want = interop.transformer_params_from(jax.tree.map(np.asarray, jout))
        for a, b in zip(tree.leaves(tout), tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = interop.transformer_params_from(jax.tree.map(np.asarray, jstate))
    for a, b in zip(tree.leaves(tstate), tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("block", [None, 256])
def test_compress_scale_is_per_stacked_leaf(block):
    """The pin: quantizing each unrolled layer on its own (a scale per
    layer; blocks that stop at the layer boundary: ``w_k`` is 1,152
    elements a layer, 4.5 blocks of 256) gives other numbers than the
    reference's stacked leaf, and ``roundtrip`` gives the reference's."""
    g = interop.transformer_params_from(_layered_grads(2))
    out, _ = compress.roundtrip(g, block=block)
    per_layer = compress._roundtrip_leaf(
        g["layers"][1]["attn"]["w_k"],
        torch.zeros_like(g["layers"][1]["attn"]["w_k"]), block)[0]
    assert not torch.equal(per_layer, out["layers"][1]["attn"]["w_k"])


def test_compression_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)),
         "b": torch.from_numpy(rng.normal(size=(128,)).astype(np.float32)
                               * 10)}
    dec, res = compress.roundtrip(g)
    for k in g:
        scale = float(g[k].abs().max())
        assert float((dec[k] - g[k]).abs().max()) <= scale / 127.0 + 1e-6


def test_error_feedback_reduces_bias():
    rng = np.random.default_rng(1)
    gs = [{"a": torch.from_numpy(rng.normal(size=(256,)).astype(np.float32)
                                 * 0.001)} for _ in range(50)]
    true_sum = sum(float(g["a"].sum()) for g in gs)
    res, acc = None, 0.0
    for g in gs:
        dec, res = compress.roundtrip(g, res)
        acc += float(dec["a"].sum())
    assert abs(acc + float(res["a"].sum()) - true_sum) < 1e-2


def test_integer_leaves_pass_through_and_blocks_are_checked():
    g = {"w": torch.ones(3), "n": torch.tensor([4, 5], dtype=torch.int32)}
    out, res = compress.roundtrip(g, block=2)
    assert torch.equal(out["n"], g["n"]) and not res["n"].any()
    with pytest.raises(ValueError):
        compress.roundtrip(g, block=3)


# ---------------------------------------------------------------------------
# the train step against the reference's
# ---------------------------------------------------------------------------

STEPS = 10


@functools.lru_cache(maxsize=None)
def _reference_trajectory(grad_compress):
    cfg, params = _reference()
    ocfg = jadamw.AdamWConfig(lr=3e-3, total_steps=STEPS,
                              warmup_steps=min(20, STEPS // 10))
    step = jax.jit(jmake_train_step(
        lambda p, b: jtr.loss_fn(p, b, cfg, RULES), ocfg,
        grad_compress=grad_compress))
    p, o = jax.tree.map(jnp.asarray, params), jadamw.init(params, ocfg)
    c = jcompress.init_state(p) if grad_compress else None
    losses, norms = [], []
    for b in _batches(STEPS):
        b = jax.tree.map(jnp.asarray, b)
        if grad_compress:
            p, o, c, m = step(p, o, c, b)
        else:
            p, o, m = step(p, o, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return np.array(losses), np.array(norms)


@pytest.mark.parametrize("grad_compress", [False, 256],
                         ids=["plain", "compress256"])
def test_train_trajectory_matches_reference(grad_compress):
    """10 SMOKE steps with the CLI's optimizer settings from the same
    weights and batches. Float32 sums in other orders drift apart through
    AdamW's normalised updates; the measured worst over 10 steps is 1.6e-7
    relative in the losses and 3.5e-6 in the grad norms (compressed: a
    rounding apart flips an int8 level), held to 1e-4."""
    want_loss, want_norm = _reference_trajectory(grad_compress)
    tcfg = tconfigs.get(ARCH).smoke_config()
    ocfg = tlaunch.optimizer_config(3e-3, STEPS)
    step = make_train_step(lambda p, b: ttr.loss_fn(p, b, tcfg), ocfg,
                           grad_compress=grad_compress)
    p = _port_params()
    o = adamw.init(p, ocfg)
    c = compress.init_state(p) if grad_compress else None
    losses, norms = [], []
    for b in _batches(STEPS):
        if grad_compress:
            p, o, c, m = step(p, o, c, _tb(b))
        else:
            p, o, m = step(p, o, _tb(b))
        assert sorted(m) == ["aux", "ce", "grad_norm", "loss", "lr"]
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses, want_loss, rtol=1e-4)
    np.testing.assert_allclose(norms, want_norm, rtol=1e-4)
    assert np.mean(losses[-2:]) < losses[0]


# ---------------------------------------------------------------------------
# checkpoints and the loop (twins of tests/test_ckpt_and_loop.py)
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 4, generator=g),
            "h": torch.randn(3, generator=g).to(torch.bfloat16),
            "nested": {"b": torch.arange(5, dtype=torch.float32),
                       "s": torch.tensor(7, dtype=torch.int32)},
            "layers": [{"x": torch.ones(2)}, {"x": torch.zeros(2)}]}


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 3, t)
    restored, step = ckpt.restore(str(tmp_path), t)
    assert step == 3
    for (path, a), b in zip(tree.flatten(t), tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    with open(tmp_path / "step_000000003" / "MANIFEST.json") as f:
        import json
        manifest = json.load(f)
    # the stated order: depth first, dict keys sorted, lists in order
    assert [m["path"] for m in manifest["leaves"]] == [
        ["h"], ["layers", "0", "x"], ["layers", "1", "x"], ["nested", "b"],
        ["nested", "s"], ["w"]]
    assert manifest["leaves"][0]["dtype"] == "bfloat16"


def test_latest_and_prune(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, t)
    assert ckpt.latest_step(str(tmp_path)) == 4
    ckpt.prune(str(tmp_path), keep=2)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4]


def test_incomplete_save_invisible(tmp_path):
    """A crash mid-save (tmp dir left behind) must not corrupt latest."""
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    os.makedirs(tmp_path / ".tmp_2")           # simulated dead partial save
    assert ckpt.latest_step(str(tmp_path)) == 1
    _, step = ckpt.restore(str(tmp_path), t)
    assert step == 1
    assert ckpt.latest_step(str(tmp_path), gc_tmp=True) == 1
    assert not (tmp_path / ".tmp_2").exists()


def test_async_saver(tmp_path):
    saver = ckpt.AsyncSaver()
    t = _tree()
    saver.save(str(tmp_path), 5, t)
    t["w"].zero_()                  # the snapshot was taken on the caller
    saver.join()
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored, _ = ckpt.restore(str(tmp_path), t)
    assert torch.equal(restored["w"], _tree()["w"])


@pytest.mark.parametrize("bad", ["shape", "dtype", "leaves"])
def test_mismatch_rejected(tmp_path, bad):
    ckpt.save(str(tmp_path), 1, _tree())
    t = _tree()
    if bad == "shape":
        t["w"] = torch.zeros(9, 4)
    elif bad == "dtype":
        t["h"] = t["h"].float()
    else:
        t["extra"] = torch.zeros(1)
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), t)


def _quadratic_setup():
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(16,))
                              .astype(np.float32))

    def loss_fn(params, batch):
        err = params["x"] - target + 0.01 * batch["noise"]
        return (err ** 2).sum(), {}

    ocfg = adamw.AdamWConfig(lr=0.05, total_steps=60, warmup_steps=0,
                             weight_decay=0.0)
    step = make_train_step(loss_fn, ocfg)
    params = {"x": torch.zeros(16)}
    opt = adamw.init(params, ocfg)

    def batches():
        rng = np.random.default_rng(1)
        while True:
            yield {"noise": torch.from_numpy(rng.normal(size=(16,))
                                             .astype(np.float32))}

    return step, params, opt, batches


def test_loop_failure_recovery(tmp_path):
    """Kill training mid-run; restart resumes from the checkpoint and ends
    at the same total step count with decreasing loss."""
    step, params, opt, batches = _quadratic_setup()
    cfg = loop.LoopConfig(total_steps=40, ckpt_every=10,
                          ckpt_dir=str(tmp_path), fail_at_step=25,
                          log_every=100)
    with pytest.raises(loop.InjectedFailure):
        loop.run(step, params, opt, batches(), cfg)
    assert ckpt.latest_step(str(tmp_path)) == 20

    cfg2 = loop.LoopConfig(total_steps=40, ckpt_every=10,
                           ckpt_dir=str(tmp_path), log_every=100)
    _, _, result = loop.run(step, params, opt, batches(), cfg2)
    assert result.resumed_from == 20
    assert result.steps_run == 20                 # only the remaining steps
    assert result.losses[-1] < result.losses[0]
    assert ckpt.latest_step(str(tmp_path)) == 40


def _smoke_run(total, ckpt_dir, grad_compress, fail_at=None, every=4):
    """A SMOKE loop run from seed-0 weights on lm_batches(seed=0), the
    stream fast-forwarded past the checkpoint it resumes from."""
    tcfg = tconfigs.get(ARCH).smoke_config()
    ocfg = tlaunch.optimizer_config(3e-3, total)
    step = make_train_step(lambda p, b: ttr.loss_fn(p, b, tcfg), ocfg,
                           grad_compress=grad_compress)
    gen = torch.Generator().manual_seed(0)
    params = ttr.init(tcfg, gen, device="cpu")
    opt = adamw.init(params, ocfg)
    start = ckpt.latest_step(ckpt_dir) or 0
    batches = tlaunch.make_batches(tcfg.vocab, BATCH, SEQ,
                                   torch.device("cpu"))
    for _ in range(start):
        next(batches)
    lcfg = loop.LoopConfig(total_steps=total, ckpt_every=every,
                           ckpt_dir=ckpt_dir, fail_at_step=fail_at,
                           grad_compress=grad_compress)
    return loop.run(step, params, opt, batches, lcfg)


@pytest.mark.parametrize("grad_compress", [False, 256],
                         ids=["plain", "compress256"])
def test_resume_equals_uninterrupted_bitwise(tmp_path, grad_compress):
    """8 steps straight against 4 steps, a checkpoint (with the residual
    when compressing) and a fresh run that resumes for the rest: the same
    operations on the same values, so the losses and the final weights
    are bitwise equal."""
    p_a, o_a, r_a = _smoke_run(8, str(tmp_path / "a"), grad_compress)
    with pytest.raises(loop.InjectedFailure):
        _smoke_run(8, str(tmp_path / "b"), grad_compress, fail_at=6)
    assert ckpt.latest_step(str(tmp_path / "b")) == 4
    p_b, o_b, r_b = _smoke_run(8, str(tmp_path / "b"), grad_compress)
    assert r_b.resumed_from == 4 and r_b.steps_run == 4
    assert r_a.losses[4:] == r_b.losses
    for a, b in zip(tree.leaves((p_a, o_a)), tree.leaves((p_b, o_b))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_trains_on_the_cpu(capsys, tmp_path):
    tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                  "3", "--ckpt-dir", str(tmp_path), "--grad-compress"])
    out = capsys.readouterr().out
    assert "arch=qwen2-1.5b" in out
    assert "steps=3 resumed_from=None loss " in out
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_cli_refuses_families_that_are_not_ported(capsys):
    """No arch of the reference's registry is left unported: the port's
    registry holds every one, and the last of them, equiformer-v2 (its
    model module picked by name, as the reference picks it), trains on the
    CPU through the CLI."""
    assert sorted(tconfigs.REGISTRY) == sorted(jconfigs.REGISTRY)
    tlaunch.main(["--arch", "equiformer-v2", "--smoke", "--device", "cpu",
                  "--steps", "2"])
    out = capsys.readouterr().out
    assert "arch=equiformer-v2" in out
    first, last = (float(v) for v in
                   out.split("steps=2 resumed_from=None loss ")[1].split()[
                       0:3:2])
    assert np.isfinite([first, last]).all()


def test_cli_refuses_equiformer_without_smoke():
    """Without ``--smoke`` the CLI refuses EquiformerV2 as it refuses the
    other GNNs: the reference CLI feeds the smoke batch to the first
    shape's config and crashes."""
    with pytest.raises(SystemExit, match=r"d_feat 8\).*d_in 1433"):
        tlaunch.main(["--arch", "equiformer-v2", "--device", "cpu",
                      "--steps", "1"])


def test_train_entry_points_need_a_card(monkeypatch):
    """Without ``--device cpu`` the CLI asks for CUDA and raises when there
    is none; so does the model's init behind it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", ARCH, "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.init(tconfigs.get(ARCH).smoke_config(), torch.Generator())
