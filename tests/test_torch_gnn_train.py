"""Port parity for GNN training: the fanout sampler exactly; PNA and
MeshGraphNet ``forward`` and ``loss_fn`` gradients, ``segment_agg``'s
gradients at ties and at std's floor, GIN's differentiable aggregation
(plain, and ``bsr_spmm`` forward with its transposed-layout backward) on an
asymmetric arc list, three AdamW steps of each kind and the decayed leaf
set, all against the JAX package on the same numpy inputs; the GNN params'
interop, the train CLI's GNN family and the partitioned-training example
against the reference example.

PNA is compared in float64 on both sides. Its std aggregator is the
one-pass ``sqrt(max(E[m^2] - E[m]^2, 1e-8))``: where a node's messages
nearly coincide (duplicate arcs of the sampler, near-equal neighbours) the
difference cancels to rounding noise of ~ulp(E[m^2]), 3e-8 at |m| ~ 0.6,
which lands above the 1e-8 floor in one package and below it in the other;
sqrt then amplifies it (measured in float32 on the small minibatch below:
logits 4.4e-4 apart, a gradient leaf 8e-4 relative). In float64 the noise
is ~1e-16 and both packages compute the function itself. MeshGraphNet and
GIN, whose sums are well conditioned, are compared in float32.
"""
import dataclasses
import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gin_tu as jgin
from repro.configs import meshgraphnet as jmgn
from repro.configs import pna as jpna
from repro.core.mapping import apply_placement as japply_placement
from repro.core.mapping import block_placement as jblock_placement
from repro.core.partitioner import PartitionConfig as JPartitionConfig
from repro.core.partitioner import partition as jpartition
from repro.core.topology import production_tree as jproduction_tree
from repro.data import pipeline as jpipeline
from repro.dist.sharding import gnn_rules
from repro.graph import generators as jgen
from repro.models import gnn as jgnn
from repro.optim import adamw as jadamw
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch import interop, tree
from repro_torch.configs import common as tcommon
from repro_torch.configs import gin_tu as tgin
from repro_torch.configs import meshgraphnet as tmgn
from repro_torch.configs import pna as tpna
from repro_torch.data import pipeline as tpipeline
from repro_torch.graph import generators as tgen
from repro_torch.kernels import bsr_spmm, ops
from repro_torch.launch import train as tlaunch
from repro_torch.models import gnn as tgnn
from repro_torch.optim import adamw
from repro_torch.train.steps import loss_and_grads, make_train_step

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import asymmetric_batch  # noqa: E402  (gate (a)'s arcs)

torch.set_num_threads(1)
RULES = gnn_rules(())

# logits and loss: float32 sums in other orders (CPU parity measured
# 7.2e-7 for MeshGraphNet, 2.3e-7 for PNA in float64 with float32 logits
# into the float32 cross-entropy); gradients: per-leaf relative L2
LOGIT_TOL = 1e-5
GRAD_REL_L2 = 1e-4

KINDS = {"pna": (jpna, tpna), "mgn": (jmgn, tmgn), "gin": (jgin, tgin)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "f64": (jnp.float64, torch.float64)}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _leaves_rel_l2(got_tree, want_tree):
    """Per-leaf relative L2 of two port trees (gradients, params)."""
    return [_rel_l2(g.detach().numpy(), w.detach().numpy())
            for g, w in zip(tree.leaves(got_tree), tree.leaves(want_tree))]


def _assert_close(got, want, tol=LOGIT_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def _graphs(n, deg, seed):
    return jgen.random_regular(n, deg, seed=seed), \
        tgen.random_regular(n, deg, seed=seed)


@pytest.mark.parametrize("fanout", [(3, 2), (5,), (4, 3, 2)])
@pytest.mark.parametrize("seed", [0, 3])
def test_sample_fanout_is_the_reference_exactly(fanout, seed):
    jg, tg = _graphs(500, 6, 1)
    seeds = np.random.default_rng(seed).choice(500, 32, replace=False)
    want = jpipeline.sample_fanout(jg, seeds, fanout,
                                   np.random.default_rng(seed + 10))
    got = tpipeline.sample_fanout(tg, seeds, fanout,
                                  np.random.default_rng(seed + 10))
    assert got.n_seeds == want.n_seeds
    for field in ("nodes", "senders", "receivers"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("pads, with_pos", [((160, 288), False),
                                            ((60, 100), True)],
                         ids=["padded", "truncated_with_pos"])
def test_minibatch_batches_are_the_reference_exactly(pads, with_pos):
    """Three batches from one seed, both when the grid's pads hold the
    sample (padding arcs into the sink) and when they cut it."""
    jg, tg = _graphs(400, 6, 1)
    jf = jpipeline.gnn_features(jg, 8, 4, seed=0, with_pos=with_pos)
    tf = tpipeline.gnn_features(tg, 8, 4, seed=0, with_pos=with_pos)
    ref = jpipeline.minibatch_batches(jg, jf, 16, (3, 2), *pads, seed=2)
    got = tpipeline.minibatch_batches(tg, tf, 16, (3, 2), *pads, seed=2)
    for _ in range(3):
        a, b = next(got), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# forward and gradients against the reference
# ---------------------------------------------------------------------------

def _minibatch():
    """A small sampled batch with duplicate arcs (the sampler draws with
    replacement) and padding arcs into the sink node."""
    g = tgen.random_regular(400, 6, seed=1)
    feats = tpipeline.gnn_features(g, 8, 4, seed=0)
    return next(tpipeline.minibatch_batches(g, feats, 16, (3, 2), 160, 288,
                                            seed=0))


BATCHES = {"smoke": lambda: tcommon.smoke_gnn_batch(d_feat=8, n_classes=4),
           "minibatch": _minibatch}


def _configs(kind, chunk, dtype):
    jmod, tmod = KINDS[kind]
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jmod.SMOKE, edge_chunk=chunk, dtype=jd),
            dataclasses.replace(tmod.SMOKE, edge_chunk=chunk, dtype=td))


@functools.lru_cache(maxsize=None)
def _reference(kind, batch_name, chunk, dtype):
    """The reference's params (seed 0), logits, loss and gradients on the
    named batch, as numpy."""
    cfg, _ = _configs(kind, chunk, dtype)
    b = {k: jnp.asarray(v) for k, v in BATCHES[batch_name]().items()}
    with jax.enable_x64(dtype == "f64"):
        params, _ = jgnn.init(jax.random.PRNGKey(0), cfg, RULES)

        @jax.jit
        def run(p, b):
            loss, grads = jax.value_and_grad(
                lambda q: jgnn.loss_fn(q, b, cfg, RULES)[0])(p)
            return jgnn.forward(p, b, cfg, RULES), loss, grads
        logits, loss, grads = run(params, b)
        return jax.tree.map(np.asarray, (params, logits, loss, grads))


CASES = [("pna", "smoke", 0, "f64"), ("pna", "smoke", 100, "f64"),
         ("pna", "minibatch", 0, "f64"), ("pna", "minibatch", 64, "f64"),
         ("mgn", "smoke", 0, "f32"), ("mgn", "minibatch", 0, "f32"),
         ("mgn", "minibatch", 64, "f32")]


@pytest.mark.parametrize("kind, batch_name, chunk, dtype", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_forward_loss_and_grads_match_the_reference(kind, batch_name, chunk,
                                                    dtype):
    """``forward`` and ``loss_fn``'s gradients, direct and over arc chunks
    (PNA's ``edge_apply`` branch), on the smoke batch and on a sampled
    batch whose duplicate arcs tie maxima and minima exactly and whose
    sink node (all padding arcs) and single-arc nodes put std on its
    floor."""
    params, logits, loss, grads = _reference(kind, batch_name, chunk, dtype)
    _, cfg = _configs(kind, chunk, dtype)
    batch = BATCHES[batch_name]()
    if batch_name == "minibatch":
        s, r = batch["senders"], batch["receivers"]
        arcs = s.astype(np.int64) * batch["x"].shape[0] + r
        assert np.unique(arcs).shape[0] < arcs.shape[0]      # duplicates
        assert (np.bincount(s, minlength=160) == 1).any()    # std's floor
    tp = interop.gnn_tree_from(params)
    assert tree.leaves(tp)[0].dtype == DTYPES[dtype][1]
    got = tgnn.forward(tp, batch, cfg)
    _assert_close(got.numpy(), logits)
    got_loss, _, got_grads = loss_and_grads(
        lambda p, b: tgnn.loss_fn(p, b, cfg), tp, batch)
    assert float(got_loss) == pytest.approx(float(loss), rel=LOGIT_TOL)
    rel = _leaves_rel_l2(got_grads, interop.gnn_tree_from(grads))
    assert max(rel) <= GRAD_REL_L2, rel


def _tied_values():
    """[10, 3] small-integer values over 6 segments: ties in every
    segment's max and min, an empty segment (4), constant segments (std's
    variance exactly 0, below its floor), and a segment (5) whose variance
    is exactly float32's 1e-8, a tie with std's floor: values 1 and -1
    over a degree of 2e8 (``segment_agg`` divides by the degrees given)."""
    v = np.array([[1, 2, 2], [1, 0, 2], [3, 3, 1], [3, 1, 1], [2, 2, 2],
                  [2, 2, 2], [5, -1, 0], [4, -1, 0], [1, 0, 0], [-1, 0, 0]],
                 np.float32)
    seg = np.array([0, 0, 1, 1, 2, 2, 3, 3, 5, 5], np.int32)
    deg = np.bincount(seg, minlength=6).astype(np.float32)
    deg[5] = 2e8
    assert np.float32(2) / deg[5] == np.float32(1e-8)
    return v, seg, deg


@pytest.mark.parametrize("kind", ["sum", "mean", "max", "min", "std"])
def test_segment_agg_gradients_match_the_reference(kind):
    """The aggregators and their gradients against ``jax.grad`` where the
    tie-breaking shows: tied maxima and minima split the gradient evenly,
    an empty segment is 0, std's floor passes no gradient below it and
    half of it at a tie (``jnp.maximum``; ``clamp_min`` would pass all)."""
    v, seg, deg = _tied_values()
    w = np.random.default_rng(1).normal(size=(6, 3)).astype(np.float32)

    def jf(x):
        out = jgnn.segment_agg(x, jnp.asarray(seg), 6, kind, jnp.asarray(deg))
        return jnp.sum(out * w), out
    (_, want), want_g = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(v))
    x = torch.tensor(v, requires_grad=True)
    got = tgnn.segment_agg(x, torch.as_tensor(seg).long(), 6, kind,
                           torch.as_tensor(deg))
    (got_g,) = torch.autograd.grad((got * torch.as_tensor(w)).sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-6)
    if kind in ("max", "min"):         # rows 0 and 1 tie in channel 0
        assert float(got_g[0, 0]) == float(got_g[1, 0]) == 0.5 * w[0, 0]
    if kind == "std":                  # the floor's tie passes half
        assert float(got_g[8, 0]) != 0.0


# ---------------------------------------------------------------------------
# GIN: the differentiable aggregation on an asymmetric arc list
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _gin_reference():
    cfg = dataclasses.replace(jgin.SMOKE, graph_level=True)
    batch = asymmetric_batch(tcommon.smoke_gnn_batch(d_feat=8, n_classes=4,
                                                graphs=8))
    params, _ = jgnn.init(jax.random.PRNGKey(1), cfg, RULES)
    params["layers"]["eps"] = jnp.asarray([0.25, -0.1], jnp.float32)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: jgnn.loss_fn(p, b, cfg, RULES)[0])(params)
    return batch, jax.tree.map(np.asarray, (params, loss, grads))


@pytest.mark.parametrize("path", ["plain", "bsr_pair", "bsr_pair_r32",
                                  "chunked"])
def test_gin_grads_on_an_asymmetric_arc_list_match_the_reference(path):
    """GIN's gradients through the plain aggregation (direct and over arc
    chunks) and through ``gnn_aggregate_bsr``'s autograd Function (the
    plain block product on the CPU, forward on A, backward on Aᵀ) against
    ``jax.grad`` on arcs whose adjacency is not symmetric."""
    batch, (params, loss, grads) = _gin_reference()
    cfg = dataclasses.replace(tgin.SMOKE, graph_level=True,
                              edge_chunk=50 if path == "chunked" else 0)
    b = dict(batch)
    if path.startswith("bsr_pair"):
        b.update(tgnn.gin_layouts(batch, block=32 if path.endswith("r32")
                                  else 128, device="cpu"))
        assert b["bsr_t"] is not b["bsr"]
    got_loss, _, got_grads = loss_and_grads(
        lambda p, bt: tgnn.loss_fn(p, bt, cfg), interop.gnn_tree_from(params),
        b)
    assert float(got_loss) == pytest.approx(float(loss), rel=LOGIT_TOL)
    rel = _leaves_rel_l2(got_grads, interop.gnn_tree_from(grads))
    assert max(rel) <= GRAD_REL_L2, rel


def test_a_backward_through_the_forward_layout_fails_the_band():
    """The planted fault: reusing A for the backward on the asymmetric
    arcs moves the encoder's gradients far outside the band, so the test
    above can fail a wrong backward."""
    batch, (params, _, grads) = _gin_reference()
    cfg = dataclasses.replace(tgin.SMOKE, graph_level=True)
    lay = tgnn.gin_layout(batch, device="cpu")
    _, _, got = loss_and_grads(
        lambda p, bt: tgnn.loss_fn(p, bt, cfg), interop.gnn_tree_from(params),
        dict(batch, bsr=lay, bsr_t=lay))
    rel = _leaves_rel_l2(got, interop.gnn_tree_from(grads))
    assert max(rel) > 100 * GRAD_REL_L2, rel


def test_prepare_bsr_pair_reuses_a_layout_only_on_symmetric_arcs():
    batch = tcommon.smoke_gnn_batch(d_feat=8, n_classes=4)
    n = batch["x"].shape[0]
    w = np.ones(batch["senders"].shape[0], np.float32)
    lay, lay_t = ops.prepare_bsr_pair(n, batch["senders"],
                                      batch["receivers"], w, 32, "cpu")
    assert lay_t is lay
    asym = asymmetric_batch(batch)
    s, r = asym["senders"], asym["receivers"]
    assert not ops.arcs_symmetric(s, r, np.ones(s.shape[0], np.float32))
    lay, lay_t = ops.prepare_bsr_pair(n, s, r, np.ones(s.shape[0],
                                                       np.float32), 32, "cpu")
    assert lay_t is not lay
    g = torch.randn(n, 5, generator=torch.Generator().manual_seed(0))
    want = ops.gnn_aggregate(torch.as_tensor(r), torch.as_tensor(s),
                             torch.ones(s.shape[0]), g, n)       # Aᵀ @ g
    got = ops.gnn_aggregate_bsr(lay_t, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    # weights count: the same arcs with other weights are not symmetric
    w2 = np.arange(s.shape[0], dtype=np.float32)
    sym_s, sym_r = batch["senders"], batch["receivers"]
    assert not ops.arcs_symmetric(sym_s, sym_r,
                                  np.arange(sym_s.shape[0], dtype=np.float32))
    assert not ops.arcs_symmetric(s, r, w2)


def test_gnn_aggregate_bsr_needs_the_transposed_layout_under_autograd():
    batch = tcommon.smoke_gnn_batch(d_feat=8, n_classes=4)
    lay = tgnn.gin_layout(batch, device="cpu")
    x = torch.randn(64, 4, requires_grad=True)
    with pytest.raises(ValueError, match="transposed layout"):
        ops.gnn_aggregate_bsr(lay, x)
    with torch.no_grad():
        assert ops.gnn_aggregate_bsr(lay, x).shape == (64, 4)


def test_bsr_aggregate_gradcheck_in_float64_on_the_plain_path():
    """Finite differences of ``BsrAggregate`` in float64 (the plain block
    product) on an asymmetric layout."""
    asym = asymmetric_batch(tcommon.smoke_gnn_batch(n=40, d_feat=8, n_classes=4))
    s, r = asym["senders"], asym["receivers"]
    lay, lay_t = ops.prepare_bsr_pair(40, s, r, np.ones(s.shape[0],
                                                        np.float32), 16, "cpu")
    lay, lay_t = (dataclasses.replace(x, blocks=x.blocks.double())
                  for x in (lay, lay_t))
    x = torch.randn(40, 3, dtype=torch.float64, requires_grad=True,
                    generator=torch.Generator().manual_seed(0))
    assert torch.autograd.gradcheck(
        lambda x: ops.BsrAggregate.apply(x, lay, lay_t), (x,))


@pytest.mark.parametrize("kind", ["gin", "pna", "mgn"])
def test_remat_keeps_the_gradients(kind):
    """``cfg.remat`` recomputes each layer in the backward: the same loss
    and gradients (GIN through the BSR pair)."""
    _, tmod = KINDS[kind]
    batch = tcommon.smoke_gnn_batch(d_feat=8, n_classes=4)
    if kind == "gin":
        batch.update(tgnn.gin_layouts(batch, device="cpu"))
    params = tgnn.init(tmod.SMOKE, torch.Generator().manual_seed(0),
                       device="cpu")
    runs = [loss_and_grads(lambda p, b, c=dataclasses.replace(
        tmod.SMOKE, remat=remat): tgnn.loss_fn(p, b, c), params, batch)
        for remat in (False, True)]
    assert float(runs[0][0]) == float(runs[1][0])
    for a, b in zip(tree.leaves(runs[0][2]), tree.leaves(runs[1][2])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# AdamW steps, the decayed leaves, interop
# ---------------------------------------------------------------------------

STEPS = 3


@pytest.mark.parametrize("kind, dtype", [("gin", "f32"), ("pna", "f64"),
                                         ("mgn", "f32")])
def test_three_adamw_steps_match_the_reference(kind, dtype):
    """Three steps of ``make_train_step`` with the CLI's optimizer settings
    on the small sampled batch (GIN aggregating through the BSR pair) from
    the reference's params: the losses, grad norms and final params."""
    jcfg, tcfg = _configs(kind, 0, dtype)
    batch = _minibatch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jo = jadamw.AdamWConfig(lr=3e-3, total_steps=STEPS,
                            warmup_steps=min(20, STEPS // 10))
    with jax.enable_x64(dtype == "f64"):
        params, _ = jgnn.init(jax.random.PRNGKey(2), jcfg, RULES)
        step = jax.jit(jmake_train_step(
            lambda p, b: jgnn.loss_fn(p, b, jcfg, RULES), jo))
        p, o, want = params, jadamw.init(params, jo), []
        for _ in range(STEPS):
            p, o, m = step(p, o, jb)
            want.append((float(m["loss"]), float(m["grad_norm"])))
        want_params = jax.tree.map(np.asarray, p)
        params = jax.tree.map(np.asarray, params)
    tb = dict(batch)
    if kind == "gin":
        tb.update(tgnn.gin_layouts(batch, device="cpu"))
    ocfg = tlaunch.optimizer_config(3e-3, STEPS)
    tstep = make_train_step(lambda p, b: tgnn.loss_fn(p, b, tcfg), ocfg)
    p = interop.gnn_tree_from(params)
    o, got = adamw.init(p, ocfg), []
    for _ in range(STEPS):
        p, o, m = tstep(p, o, tb)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    rel = _leaves_rel_l2(p, interop.gnn_tree_from(want_params))
    assert max(rel) <= GRAD_REL_L2, rel


@pytest.mark.parametrize("kind", ["gin", "pna", "mgn"])
def test_decayed_leaves_are_the_references(kind):
    """With zero gradients an AdamW step is the decay alone: the port must
    move exactly the leaves the reference moves (every per-layer weight
    and bias, stacked to rank 2 there; not GIN's eps, nor the heads'
    biases)."""
    jcfg, _ = _configs(kind, 0, "f32")
    params, _ = jgnn.init(jax.random.PRNGKey(0), jcfg, RULES)
    params = jax.tree.map(lambda p: p + 0.5, params)
    cfg = jadamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10,
                             min_lr_frac=1.0)
    zeros = jax.tree.map(jnp.zeros_like, params)
    jp, _, _ = jax.jit(jadamw.update, static_argnums=3)(
        zeros, jadamw.init(params, cfg), params, cfg)
    want = interop.gnn_tree_from(jax.tree.map(np.asarray, jp))
    tp0 = interop.gnn_tree_from(jax.tree.map(np.asarray, params))
    tcfg = adamw.AdamWConfig(**dataclasses.asdict(cfg))
    tp, _, _ = adamw.update(
        interop.gnn_tree_from(jax.tree.map(np.asarray, zeros)),
        adamw.init(tp0, tcfg), tp0, tcfg)
    moved = {"/".join(map(str, path)) for (path, a), b in zip(
        tree.flatten(tp), tree.leaves(tp0)) if not torch.equal(a, b)}
    ref_moved = {"/".join(map(str, path)) for (path, a), b in zip(
        tree.flatten(want), tree.leaves(tp0)) if not torch.equal(a, b)}
    assert moved == ref_moved
    assert "layers/0/" + {"gin": "mlp/b/0", "pna": "post/b/0",
                          "mgn": "edge/ln"}[kind] in moved
    assert "encode/b/0" not in moved
    if kind == "gin":
        assert "layers/1/eps" not in moved


@pytest.mark.parametrize("kind", ["gin", "pna", "mgn"])
def test_gnn_params_from_every_kind(kind):
    """The reference's params map onto the port's layout leaf for leaf
    (names and shapes of the port's own ``init``); GIN's names are the
    serving module's state dict."""
    jcfg, tcfg = _configs(kind, 0, "f32")
    params, _ = jgnn.init(jax.random.PRNGKey(0), jcfg, RULES)
    state = interop.gnn_params_from(params)
    own = tgnn.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    names = {".".join(map(str, p)): leaf.shape for p, leaf in
             tree.flatten(own)}
    assert {k: v.shape for k, v in state.items()} == names
    if kind == "gin":
        assert set(state) == set(tgnn.GIN(tcfg, device="cpu").state_dict())
    layer = {"gin": "mlp.w.1", "pna": "pre.w.0", "mgn": "node.ln"}[kind]
    first = {"gin": ("mlp", "w", 1), "pna": ("pre", "w", 0),
             "mgn": ("node", "ln")}[kind]
    ref = params["layers"]
    for key in first:
        ref = ref[key]
    np.testing.assert_array_equal(state[f"layers.1.{layer}"].numpy(),
                                  np.asarray(ref)[1])


# ---------------------------------------------------------------------------
# the CLI and the example
# ---------------------------------------------------------------------------

def test_gin_module_serves_inits_params_through_loss_fn():
    """The serving module holds :func:`init`'s draws for the same seed
    under their paths, ``params()`` follows a ``load_state_dict(assign=
    True)``, and its ``loss`` is ``loss_fn`` on the batch with its layout;
    without layouts, on the CPU, ``loss_fn`` is the ``plain_aggregate``
    hook's loss."""
    cfg = dataclasses.replace(tgin.SMOKE, graph_level=True)
    model = tgnn.GIN(cfg, generator=torch.Generator().manual_seed(3),
                     device="cpu")
    own = tgnn.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    for a, b in zip(tree.leaves(model.params()), tree.leaves(own)):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    moved = tree.map_(lambda t: t + 0.25, own)
    model.load_state_dict({".".join(map(str, p)): t for p, t in
                           tree.flatten(moved)}, assign=True)
    for a, b in zip(tree.leaves(model.params()), tree.leaves(moved)):
        assert a is not b and torch.equal(a.detach(), b)
    batch = asymmetric_batch(tcommon.smoke_gnn_batch(d_feat=8, n_classes=4,
                                                     graphs=8))
    lays = tgnn.gin_layouts(batch, block=32, device="cpu")
    want = float(tgnn.loss_fn(moved, dict(batch, **lays), cfg)[0])
    got = float(model.loss(batch, tgnn.gin_layout(batch, block=32,
                                                  device="cpu")))
    assert got == pytest.approx(want, rel=LOGIT_TOL)
    plain = float(tgnn.loss_fn(moved, batch, cfg)[0])
    hooked = float(tgnn.loss_fn(moved, batch, cfg,
                                tgnn.plain_aggregate(batch))[0])
    assert plain == hooked
    assert plain == pytest.approx(want, rel=LOGIT_TOL)


@pytest.mark.parametrize("arch", ["gin-tu", "pna", "meshgraphnet"])
def test_cli_trains_each_gnn_on_its_smoke_batch(arch, capsys):
    tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                  "2"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out
    first, last = (float(v) for v in
                   out.split("steps=2 resumed_from=None loss ")[1].split()[
                       0:3:2])
    assert np.isfinite([first, last]).all() and last < first


def test_cli_gin_batches_carry_their_layouts():
    args = tlaunch._parser().parse_args(["--arch", "gin-tu", "--smoke",
                                         "--device", "cpu", "--steps", "1"])
    b = next(tlaunch.build(args).batches(0))
    assert isinstance(b["bsr"], bsr_spmm.BsrLayout)
    assert b["bsr_t"] is b["bsr"]          # the smoke graph is symmetric
    assert b["bsr"].n_nodes == b["x"].shape[0]


@pytest.mark.parametrize("arch", ["gin-tu", "pna", "meshgraphnet"])
def test_cli_refuses_a_gnn_without_smoke(arch):
    with pytest.raises(SystemExit, match=r"d_feat 8\).*d_in 1433"):
        tlaunch.main(["--arch", arch, "--device", "cpu", "--steps", "1"])


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_gnn_partitioned_training",
        ROOT / "examples" / "torch_gnn_partitioned_training.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_losses_match_the_reference_example():
    """The reference example's partition and GIN params, fed through
    ``interop``: the port's first 10 losses (BSR forward and transposed
    backward, plain on the CPU) against the reference's jitted steps."""
    g = jgen.rmat(2000, 12000, seed=0)
    topo = jproduction_tree(2, 2, 4)
    part = np.asarray(jpartition(g, topo, JPartitionConfig(seed=0)).part)
    pl = jblock_placement(part, topo.k)
    g2 = japply_placement(g, pl)
    feats = jpipeline.gnn_features(g, 32, 8, seed=0)
    x = np.zeros((pl.n_pad, 32), np.float32)
    x[pl.perm] = feats["x"]
    labels = np.zeros(pl.n_pad, np.int32)
    labels[pl.perm] = feats["labels"]
    mask = np.zeros(pl.n_pad, np.float32)
    mask[pl.perm] = 1.0
    jb = {"x": x, "labels": labels, "label_mask": mask,
          "senders": g2.senders, "receivers": g2.receivers,
          "edge_weight": g2.edge_weight,
          "degrees": g2.degrees().astype(np.float32)}
    cfg = jgnn.GNNConfig(name="gin", kind="gin", n_layers=3, d_hidden=64,
                         d_in=32, n_classes=8)
    params, _ = jgnn.init(jax.random.PRNGKey(0), cfg, RULES)
    ocfg = jadamw.AdamWConfig(lr=3e-3, total_steps=80, warmup_steps=0)
    step = jax.jit(jmake_train_step(
        lambda p, b: jgnn.loss_fn(p, b, cfg, RULES), ocfg))
    p, o, want = params, jadamw.init(params, ocfg), []
    jbd = {k: jnp.asarray(v) for k, v in jb.items()}
    for _ in range(10):
        p, o, m = step(p, o, jbd)
        want.append(float(m["loss"]))

    ex = _example()
    batch = ex.placed_batch(interop.graph_from_arrays(g),
                            interop.topology_from_arrays(topo), part)
    for k in jb:
        np.testing.assert_array_equal(batch[k], jb[k], err_msg=k)
    _, got = ex.train(batch, interop.gnn_tree_from(
        jax.tree.map(np.asarray, params)), 10, "cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4)
