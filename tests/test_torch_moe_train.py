"""Port parity for MoE + MLA training (DeepSeek-V2): one step's loss, its
``ce`` and ``aux`` and every gradient leaf against ``jax.value_and_grad``
of the reference's ``loss_fn`` at both DeepSeek-V2 SMOKE configs, with and
without dropped pairs; three AdamW steps through ``make_train_step``
against the reference's trajectory; ``remat`` bitwise; the training CLI.
Weights are the reference's, carried across by
``interop.transformer_params_from``; batches are ``lm_batches`` from a
numpy seed. All on the CPU."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.dist.sharding import lm_rules
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch import interop, tree
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as ttr
from repro_torch.optim import adamw
from repro_torch.train.steps import loss_and_grads, make_train_step

torch.set_num_threads(1)
RULES = lm_rules(())
NAMES = ["deepseek-v2-lite-16b", "deepseek-v2-236b"]
BATCH, SEQ = 2, 16
# 4.0 routes every pair at SMOKE (8 experts, top-2 over 32 tokens: 32
# slots an expert); 1.0 leaves 8 slots an expert and drops pairs
CAPACITY_FACTORS = [4.0, 1.0]
# tests/test_torch_train.py's float32 bands: the same float32 products in
# other orders, through a router, 2 layers and a 512-way softmax (the
# measured worst leaf here is 1.5e-6: 60x room)
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
STEPS = 3


@functools.lru_cache(maxsize=None)
def _reference(name, capacity_factor=None):
    """(reference cfg, numpy params) at SMOKE from PRNGKey(0), with
    ``capacity_factor`` replaced where given."""
    cfg = jconfigs.get(name).smoke_config()
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    params, _ = jtr.init(jax.random.PRNGKey(0), cfg, RULES)
    return cfg, jax.tree.map(np.asarray, params)


def _port_cfg(name, capacity_factor=None, **kw):
    cfg = tconfigs.get(name).smoke_config()
    if capacity_factor is not None:
        kw["capacity_factor"] = capacity_factor
    return dataclasses.replace(cfg, **kw)


def _batches(name, n):
    gen = jpipeline.lm_batches(_reference(name)[0].vocab, BATCH, SEQ, seed=0)
    return [next(gen) for _ in range(n)]


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_tree_close(got, want, rel=GRAD_REL_L2):
    """Port tree ``got`` against the reference's stacked tree ``want``,
    leaf by leaf; returns the worst leaf's relative L2."""
    want = interop.transformer_params_from(want)
    worst = 0.0
    for (path, g), w in zip(tree.flatten(got), tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape), path
        err = _rel_l2(g.float().numpy(), w.float().numpy())
        assert err <= rel, (path, err)
        worst = max(worst, err)
    return worst


def _dropped(params, batch, cfg):
    """Each MoE layer's dropped share in the port's forward."""
    seen = []
    real = ttr.moe_ffn

    def record(*args):
        y, stats = real(*args)
        seen.append(float(stats.dropped_frac))
        return y, stats
    ttr.moe_ffn = record
    try:
        with torch.no_grad():
            ttr.forward(params, batch["tokens"], cfg)
    finally:
        ttr.moe_ffn = real
    return seen


@pytest.mark.parametrize("capacity_factor", CAPACITY_FACTORS,
                         ids=["no_drops", "drops"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_reference(name, capacity_factor):
    """Loss, ``ce`` and ``aux`` and every gradient leaf: the router's, the
    experts', MLA's (``w_q`` or the q-LoRA branch) and the embedding's. At
    capacity 1.0 pairs drop; which ones is fixed by the stable sort, so
    both packages drop the same set and the dump row takes no gradient."""
    cfg, params = _reference(name, capacity_factor)
    batch = _batches(name, 1)[0]
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jtr.loss_fn(p, jax.tree.map(jnp.asarray, batch), cfg,
                              RULES), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tcfg = _port_cfg(name, capacity_factor)
    tparams = interop.transformer_params_from(params)
    tloss, taux, tgrads = loss_and_grads(
        lambda p, b: ttr.loss_fn(p, b, tcfg), tparams, _tb(batch))
    np.testing.assert_allclose(float(tloss.detach()), float(loss),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(taux["ce"]), float(aux["ce"]),
                               rtol=LOSS_RTOL)
    assert float(aux["aux"]) > 0.0
    np.testing.assert_allclose(float(taux["aux"]), float(aux["aux"]),
                               rtol=LOSS_RTOL)
    _assert_tree_close(tgrads, jax.tree.map(np.asarray, grads))
    # every routed expert got a gradient, the router too
    for layer in tgrads["layers"][tcfg.n_dense_layers:]:
        assert float(layer["ffn"]["router"].abs().sum()) > 0
    dropped = _dropped(tparams, _tb(batch), tcfg)
    assert (max(dropped) > 0) == (capacity_factor == 1.0)


@functools.lru_cache(maxsize=None)
def _reference_trajectory(name):
    """The reference's STEPS steps with the CLI's optimizer settings:
    (losses, grad norms, final numpy params)."""
    cfg, params = _reference(name)
    ocfg = jadamw.AdamWConfig(lr=3e-3, total_steps=STEPS,
                              warmup_steps=min(20, STEPS // 10))
    step = jax.jit(jmake_train_step(
        lambda p, b: jtr.loss_fn(p, b, cfg, RULES), ocfg))
    p, o = jax.tree.map(jnp.asarray, params), jadamw.init(params, ocfg)
    losses, norms = [], []
    for b in _batches(name, STEPS):
        p, o, m = step(p, o, jax.tree.map(jnp.asarray, b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return np.array(losses), np.array(norms), jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("name", NAMES)
def test_train_trajectory_matches_reference(name):
    """Three AdamW steps from the same weights on the same batches: the
    losses and grad norms to 1e-4 relative, as the dense LM's trajectory
    test holds them, and every final parameter leaf to GRAD_REL_L2 of its
    own L2 norm. Measured: losses 7.3e-8, grad norms 3.1e-7, the worst
    final leaf 4.7e-6 (lite) and 1.4e-6 (236b)."""
    want_loss, want_norm, want_params = _reference_trajectory(name)
    tcfg = _port_cfg(name)
    ocfg = tlaunch.optimizer_config(3e-3, STEPS)
    step = make_train_step(lambda p, b: ttr.loss_fn(p, b, tcfg), ocfg)
    p = interop.transformer_params_from(_reference(name)[1])
    o = adamw.init(p, ocfg)
    losses, norms = [], []
    for b in _batches(name, STEPS):
        p, o, m = step(p, o, _tb(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses, want_loss, rtol=1e-4)
    np.testing.assert_allclose(norms, want_norm, rtol=1e-4)
    _assert_tree_close(p, want_params)


def test_remat_keeps_the_gradients():
    """With ``remat`` each layer's forward runs again in the backward; the
    recompute must route and drop the same pairs (a stable sort and
    ``topk`` on the same inputs), so the loss and every gradient are
    bitwise those without it, here with pairs dropped."""
    name = NAMES[0]
    params = interop.transformer_params_from(_reference(name, 1.0)[1])
    batch = _tb(_batches(name, 1)[0])
    runs = [loss_and_grads(lambda p, b, c=_port_cfg(name, 1.0, remat=remat):
                           ttr.loss_fn(p, b, c), params, batch)
            for remat in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1]["aux"], runs[1][1]["aux"])
    for a, b in zip(tree.leaves(runs[0][2]), tree.leaves(runs[1][2])):
        assert torch.equal(a, b)


def test_remat_recomputes_the_moe_dispatch(monkeypatch):
    """With remat a step runs each MoE layer's ``moe_ffn`` twice (the
    forward and the recompute), without it once."""
    calls = []
    real = ttr.moe_ffn

    def count(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(ttr, "moe_ffn", count)
    name = NAMES[0]
    params = interop.transformer_params_from(_reference(name)[1])
    batch = _tb(_batches(name, 1)[0])
    for remat, want in ((False, 1), (True, 2)):
        calls.clear()
        cfg = _port_cfg(name, remat=remat)
        loss_and_grads(lambda p, b: ttr.loss_fn(p, b, cfg), params, batch)
        assert len(calls) == want * (cfg.n_layers - cfg.n_dense_layers)


def test_cli_trains_deepseek_on_the_cpu(capsys):
    tlaunch.main(["--arch", "deepseek-v2-lite-16b", "--smoke", "--device",
                  "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert "arch=deepseek-v2-lite-16b" in out
    first, last = (float(v) for v in
                   out.split("steps=2 resumed_from=None loss ")[1].split()[
                       0:3:2])
    assert np.isfinite([first, last]).all()
