"""Port parity for EquiformerV2 (``repro_torch.models.equiformer`` and
``configs/equiformer_v2.py``): ``lm_indices``, ``so2_apply``,
``equi_layer_norm`` and ``gate_act``, ``forward`` (node- and graph-level),
``loss_fn`` and every gradient leaf, and one AdamW step with the decayed
leaf set, all against the JAX package on the same numpy inputs (the
reference's params carried across by ``interop.gnn_tree_from``); the
chunked arc path against the direct one, rotation invariance in float64
and ``remat`` within the port; the configs and the shapes of the
parameters at full width against the reference's. The reference has no
kernel here, so every function runs as its own tests run it on the CPU.
Each tolerance is stated where it is used."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.configs import equiformer_v2 as jeq_cfg
from repro.dist.sharding import gnn_rules
from repro.models import equiformer as jeq
from repro.optim import adamw as jadamw
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch import interop, tree
from repro_torch.configs import common as tcommon
from repro_torch.configs import equiformer_v2 as teq_cfg
from repro_torch.launch import train as tlaunch
from repro_torch.models import equiformer as teq
from repro_torch.models import so3 as tso3
from repro_torch.optim import adamw
from repro_torch.train.steps import loss_and_grads, make_train_step

torch.set_num_threads(1)
RULES = gnn_rules(())
# logits: float32 sums in other orders through 2 layers of GEMMs, rotations
# and a segment softmax: |d| <= LOGIT_TOL * (max|logit| + |logit|)
LOGIT_TOL = 1e-5
# the loss: relative; gradients: each leaf's relative L2
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
# one op (a few float32 GEMMs or a reduction) in another summation order,
# relative to the output's largest magnitude
OP_RTOL = 1e-6

# the reference test's config (tests/test_so3.py)
REF_FIELDS = dict(name="t", n_layers=2, channels=16, l_max=3, m_max=2,
                  n_heads=4, d_in=8, n_classes=4)
CONFIGS = {"smoke": (jeq_cfg.SMOKE, teq_cfg.SMOKE),
           "ref_test": (jeq.EquiformerConfig(**REF_FIELDS),
                        teq.EquiformerConfig(**REF_FIELDS))}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _leaves_rel_l2(got_tree, want_tree):
    return [_rel_l2(g.detach().numpy(), w.detach().numpy())
            for g, w in zip(tree.leaves(got_tree), tree.leaves(want_tree))]


def _close_to_max(got, want, tol):
    """|got - want| <= tol * (max|want| + |want|), elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= tol * (np.abs(want).max() + np.abs(want))).all(), \
        err.max()


def _graph(level):
    """The reference test's batch (48 nodes, degree 4, with positions),
    node-level or as 8 molecules of 6 nodes."""
    graphs = 8 if level == "graph" else 0
    return tcommon.smoke_gnn_batch(n=48, deg=4, d_feat=8, n_classes=4,
                                   with_pos=True, graphs=graphs)


def _configs(name, level, **kw):
    jc, tc = CONFIGS[name]
    fields = dict(graph_level=level == "graph", **kw)
    return (dataclasses.replace(jc, **fields),
            dataclasses.replace(tc, **fields))


@functools.lru_cache(maxsize=None)
def _ref_params(name, seed=0):
    jc, _ = CONFIGS[name]
    params, _ = jeq.init(jax.random.PRNGKey(seed), jc, RULES)
    return jax.tree.map(np.asarray, params)


def _port_params(name, seed=0):
    return interop.gnn_tree_from(_ref_params(name, seed))


# ---------------------------------------------------------------------------
# the configs and the index bookkeeping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l_max, m_max", [(1, 1), (2, 1), (3, 2), (6, 2),
                                          (6, 6)])
def test_lm_indices_equal_the_reference(l_max, m_max):
    want = jeq.lm_indices(l_max, m_max)
    got = teq.lm_indices(l_max, m_max)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        np.testing.assert_array_equal(g, w)
    assert len(got[1]) == len(want[1]) == m_max
    np.testing.assert_array_equal(got[3], want[3])


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "dtype"}


@pytest.mark.parametrize("shape", list(jcommon.GNN_SHAPE_META))
def test_make_config_and_model_flops_equal_the_reference(shape):
    assert _fields(teq_cfg.ARCH.make_config(shape)) == _fields(
        jeq_cfg.ARCH.make_config(shape))
    assert teq_cfg.ARCH.make_config(shape).dtype == torch.float32
    assert teq_cfg.ARCH.model_flops(shape) == jeq_cfg.ARCH.model_flops(shape)


def test_base_smoke_and_arch_equal_the_reference():
    assert _fields(teq_cfg.BASE) == _fields(jeq_cfg.BASE)
    assert _fields(teq_cfg.SMOKE) == _fields(jeq_cfg.SMOKE)
    assert list(teq_cfg.ARCH.shapes) == list(jeq_cfg.ARCH.shapes)
    assert teq_cfg.ARCH.family == jeq_cfg.ARCH.family == "gnn"
    want, got = jeq_cfg.ARCH.smoke_batch(), teq_cfg.ARCH.smoke_batch()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_full_width_parameters_have_the_references_shapes():
    """``init`` at the molecule config (12 x 128, l_max 6, m_max 2) on the
    meta device: the same leaves and shapes as the reference's stacked
    params (``jax.eval_shape``), 103.3 M in all."""
    jc = jeq_cfg.ARCH.make_config("molecule")
    shapes = jax.eval_shape(lambda k: jeq.init(k, jc, RULES)[0],
                            jax.random.PRNGKey(0))
    own = teq.init(teq_cfg.ARCH.make_config("molecule"), None, device="meta")
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "layers":
            for li in range(leaf.shape[0]):
                want["/".join(map(str, ["layers", li] + keys[1:]))] = \
                    tuple(leaf.shape[1:])
        else:
            want["/".join(map(str, keys))] = tuple(leaf.shape)
    got = {"/".join(map(str, p)): tuple(t.shape) for p, t in
           tree.flatten(own)}
    assert got == want
    n = sum(int(np.prod(s)) for s in got.values())
    assert round(n / 1e6, 1) == 103.3


def test_interop_unstacks_the_nested_so2_dicts():
    """``gnn_tree_from`` maps the reference's stacked Equiformer params onto
    the port's ``init`` layout leaf for leaf, the nested ``conv1`` /
    ``conv2`` dicts and the ``rbf_mlp`` lists included."""
    _, tc = CONFIGS["ref_test"]
    ref = _ref_params("ref_test")
    got = interop.gnn_tree_from(ref)
    own = teq.init(tc, torch.Generator().manual_seed(0), device="cpu")
    assert [(p, tuple(t.shape)) for p, t in tree.flatten(got)] == \
        [(p, tuple(t.shape)) for p, t in tree.flatten(own)]
    np.testing.assert_array_equal(got["layers"][1]["conv1"]["w2_i"].numpy(),
                                  ref["layers"]["conv1"]["w2_i"][1])
    np.testing.assert_array_equal(got["layers"][0]["rbf_mlp"]["w"][1].numpy(),
                                  ref["layers"]["rbf_mlp"]["w"][1][0])
    flat = interop.gnn_params_from(ref)
    assert "layers.1.conv2.w1_r" in flat and "layers.0.ln2" in flat


# ---------------------------------------------------------------------------
# the layer's pieces
# ---------------------------------------------------------------------------

def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name, c_in", [("smoke", 16), ("ref_test", 32)])
def test_so2_apply_matches_the_reference(name, c_in):
    jc, tc = CONFIGS[name]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(40, tc.m_dim, c_in)).astype(np.float32)
    p, _ = jeq.so2_init(jax.random.PRNGKey(1), jc, c_in, tc.channels, RULES)
    want = np.asarray(jeq.so2_apply(p, jnp.asarray(x), jc, tc.channels))
    tp = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    got = teq.so2_apply(tp, torch.as_tensor(x), tc, tc.channels).numpy()
    assert _rel_max(got, want) <= OP_RTOL


def test_so2_apply_mixes_only_orders_plus_minus_m():
    """Output order m reads only input orders ±m; orders above m_max are
    zero (the eSCN truncation)."""
    _, tc = CONFIGS["ref_test"]
    c = tc.channels
    p = teq.so2_init(tc, c, c, torch.Generator().manual_seed(0),
                     torch.device("cpu"))
    rows0, rows_pos, rows_neg, _ = teq.lm_indices(tc.l_max, tc.m_max)
    m_of = np.zeros(tc.m_dim, int)
    for m in range(1, tc.m_max + 1):
        m_of[rows_pos[m - 1]] = m
        m_of[rows_neg[m - 1]] = m
    kept = np.zeros(tc.m_dim, bool)
    kept[np.concatenate([rows0] + rows_pos + rows_neg)] = True
    for m in range(tc.m_max + 1):
        x = torch.zeros(3, tc.m_dim, c)
        x[:, torch.as_tensor(np.flatnonzero(kept & (m_of == m)))] = 1.0
        y = teq.so2_apply(p, x, tc, c).abs().sum((0, 2)).numpy()
        assert (y[kept & (m_of == m)] > 0).all()
        assert (y[~(kept & (m_of == m))] == 0).all()
    x = torch.zeros(3, tc.m_dim, c)
    x[:, torch.as_tensor(np.flatnonzero(~kept))] = 1.0
    assert teq.so2_apply(p, x, tc, c).abs().sum() == 0


@pytest.mark.parametrize("l_max", [2, 6])
def test_equi_layer_norm_matches_the_reference(l_max):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(20, (l_max + 1) ** 2, 16)).astype(np.float32)
    gamma = rng.normal(size=16).astype(np.float32)
    _, _, _, l_of = jeq.lm_indices(l_max, 1)
    want = np.asarray(jeq.equi_layer_norm(jnp.asarray(x), jnp.asarray(gamma),
                                          l_of))
    got = teq.equi_layer_norm(torch.as_tensor(x), torch.as_tensor(gamma),
                              l_max).numpy()
    assert _rel_max(got, want) <= OP_RTOL


def test_gate_act_matches_the_reference():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(20, 16, 24)).astype(np.float32)
    w = rng.normal(size=(24, 24)).astype(np.float32) / 5
    _, _, _, l_of = jeq.lm_indices(3, 2)
    want = np.asarray(jeq.gate_act(jnp.asarray(x), jnp.asarray(w), l_of))
    got = teq.gate_act(torch.as_tensor(x), torch.as_tensor(w)).numpy()
    assert _rel_max(got, want) <= OP_RTOL


def test_index_tensors_are_made_once_per_device():
    _, tc = CONFIGS["ref_test"]
    a = teq._indices(tc.l_max, tc.m_max, torch.device("cpu"))
    teq.forward(_port_params("ref_test"), _graph("node"), tc)
    assert teq._indices(tc.l_max, tc.m_max, torch.device("cpu")) is a


# ---------------------------------------------------------------------------
# the model: forward, loss, gradients, one AdamW step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", ["node", "graph"])
@pytest.mark.parametrize("name", ["smoke", "ref_test"])
def test_forward_matches_the_reference(name, level):
    jc, tc = _configs(name, level)
    batch = _graph(level)
    want = np.asarray(jeq.forward(jax.tree.map(jnp.asarray,
                                               _ref_params(name)),
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jc, RULES))
    got = teq.forward(_port_params(name), batch, tc).detach().numpy()
    assert got.shape == (8 if level == "graph" else 48, tc.n_classes)
    _close_to_max(got, want, LOGIT_TOL)


def _reference_grads(name, level, batch):
    jc, _ = _configs(name, level)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jeq.loss_fn(p, jb, jc, RULES), has_aux=True)(
        jax.tree.map(jnp.asarray, _ref_params(name)))
    return float(loss), interop.gnn_tree_from(jax.tree.map(np.asarray,
                                                           grads))


@pytest.mark.parametrize("level", ["node", "graph"])
@pytest.mark.parametrize("name", ["smoke", "ref_test"])
def test_loss_and_grads_match_the_reference(name, level):
    _, tc = _configs(name, level)
    batch = _graph(level)
    want_loss, want = _reference_grads(name, level, batch)
    loss, _, grads = loss_and_grads(lambda p, b: teq.loss_fn(p, b, tc),
                                    _port_params(name), batch)
    assert float(loss) == pytest.approx(want_loss, rel=LOSS_RTOL)
    rel = _leaves_rel_l2(grads, want)
    assert max(rel) <= GRAD_REL_L2, rel


def test_one_adamw_step_matches_the_reference():
    """One ``make_train_step`` with the CLI's optimizer settings (lr 3e-3,
    one step) on the reference's params: loss and grad norm rel 1e-4 (the
    GNN family's band), the new params each leaf within relative L2
    1e-4."""
    jc, tc = _configs("ref_test", "graph")
    batch = _graph("graph")
    jo = jadamw.AdamWConfig(lr=3e-3, total_steps=1, warmup_steps=0)
    params = jax.tree.map(jnp.asarray, _ref_params("ref_test"))
    jp, _, jm = jax.jit(jmake_train_step(
        lambda p, b: jeq.loss_fn(p, b, jc, RULES), jo))(
        params, jadamw.init(params, jo),
        {k: jnp.asarray(v) for k, v in batch.items()})
    ocfg = tlaunch.optimizer_config(3e-3, 1)
    assert dataclasses.asdict(ocfg) == dataclasses.asdict(jo)
    p = _port_params("ref_test")
    tp, _, tm = make_train_step(lambda p, b: teq.loss_fn(p, b, tc), ocfg)(
        p, adamw.init(p, ocfg), batch)
    np.testing.assert_allclose(
        [float(tm["loss"]), float(tm["grad_norm"])],
        [float(jm["loss"]), float(jm["grad_norm"])], rtol=1e-4)
    rel = _leaves_rel_l2(tp, interop.gnn_tree_from(jax.tree.map(np.asarray,
                                                                jp)))
    assert max(rel) <= GRAD_REL_L2, rel


def test_decayed_leaves_are_the_references():
    """With zero gradients an AdamW step is the decay alone: the port must
    move exactly the leaves the reference moves (every per-layer leaf,
    stacked to rank 2 there, ``ln1`` and ``ln2`` too; not the heads'
    biases)."""
    params = jax.tree.map(lambda p: jnp.asarray(p) + 0.5,
                          _ref_params("ref_test"))
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

    def moved(t):
        return {"/".join(map(str, path)) for (path, a), b in zip(
            tree.flatten(t), tree.leaves(tp0)) if not torch.equal(a, b)}
    assert moved(tp) == moved(want)
    for leaf in ("layers/0/ln1", "layers/1/ln2", "layers/0/conv1/w0",
                 "layers/1/rbf_mlp/b/0"):
        assert leaf in moved(tp)
    assert "encode/b/0" not in moved(tp) and "decode/b/1" not in moved(tp)


# ---------------------------------------------------------------------------
# the chunked arcs, invariance, remat (the port alone)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", ["node", "graph"])
def test_chunked_arcs_equal_the_direct_path(level):
    """``edge_chunk`` 37 (192 arcs: 6 blocks, the last padded into the dump
    row) against 0: logits, loss and gradients in the bands above."""
    _, tc = _configs("ref_test", level)
    tcc = dataclasses.replace(tc, edge_chunk=37)
    batch = _graph(level)
    params = _port_params("ref_test")
    _close_to_max(teq.forward(params, batch, tcc).detach().numpy(),
                  teq.forward(params, batch, tc).detach().numpy(), LOGIT_TOL)
    want = loss_and_grads(lambda p, b: teq.loss_fn(p, b, tc), params, batch)
    got = loss_and_grads(lambda p, b: teq.loss_fn(p, b, tcc), params, batch)
    assert float(got[0]) == pytest.approx(float(want[0]), rel=LOSS_RTOL)
    rel = _leaves_rel_l2(got[2], want[2])
    assert max(rel) <= GRAD_REL_L2, rel


def _rotation(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.linalg.det(q)


@pytest.mark.parametrize("chunk", [0, 37])
def test_rotation_invariance_at_l_max_6_in_float64(chunk):
    """Rotating every position leaves the scalar readout's logits unchanged
    to 1e-9 of their largest (float64; the reference test holds float32 to
    2e-4 absolute). Rotating back by D instead of Dᵀ breaks it."""
    cfg = teq.EquiformerConfig(name="t", n_layers=2, channels=16, l_max=6,
                               m_max=2, n_heads=4, d_in=8, n_classes=4,
                               edge_chunk=chunk, dtype=torch.float64)
    params = teq.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _graph("node")
    rot = dict(batch, pos=batch["pos"].astype(np.float64)
               @ _rotation(5).T)
    with torch.no_grad():
        a = teq.forward(params, batch, cfg).numpy()
        b = teq.forward(params, rot, cfg).numpy()
    assert np.abs(a).max() > 0.1
    assert np.abs(a - b).max() <= 1e-9 * np.abs(a).max()


def test_rotating_back_by_d_breaks_invariance(monkeypatch):
    """The planted fault of the card's gate (d): the value messages rotated
    back by D, not Dᵀ. The logits then move with the rotation by far more
    than the band."""
    cfg = teq.EquiformerConfig(name="t", n_layers=2, channels=16, l_max=6,
                               m_max=2, n_heads=4, d_in=8, n_classes=4,
                               dtype=torch.float64)
    params = teq.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _graph("node")
    rot = dict(batch, pos=batch["pos"].astype(np.float64)
               @ _rotation(5).T)
    rotate = teq._rotate
    monkeypatch.setattr(teq, "_rotate", lambda d, x, l_max, transpose=False:
                        rotate(d, x, l_max))
    with torch.no_grad():
        a = teq.forward(params, batch, cfg).numpy()
        b = teq.forward(params, rot, cfg).numpy()
    assert np.abs(a - b).max() > 1e-3 * np.abs(a).max()


def test_remat_keeps_the_loss_and_gradients_bitwise():
    _, tc = _configs("ref_test", "graph")
    batch = _graph("graph")
    params = _port_params("ref_test")
    runs = [loss_and_grads(lambda p, b, c=dataclasses.replace(
        tc, remat=remat): teq.loss_fn(p, b, c), params, batch)
        for remat in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(tree.leaves(runs[0][2]), tree.leaves(runs[1][2])):
        assert torch.equal(a, b)


def test_rotate_applies_d_and_its_transpose():
    """``_rotate`` applies each l's block D (or Dᵀ) to that l's rows: the
    dense block-diagonal product, and Dᵀ undoes D."""
    rng = np.random.default_rng(14)
    q = torch.as_tensor(np.stack([_rotation(s) for s in range(5)]))
    x = torch.as_tensor(rng.normal(size=(5, 16, 3)))
    blocks = tso3.wigner_d_stack(q, 3)
    dense = tso3.block_diag_wigner(q, 3)
    torch.testing.assert_close(teq._rotate(blocks, x, 3), dense @ x,
                               rtol=1e-12, atol=1e-12)
    back = teq._rotate(blocks, teq._rotate(blocks, x, 3), 3, transpose=True)
    torch.testing.assert_close(back, x, rtol=1e-12, atol=1e-12)


def test_forward_needs_no_grad_and_takes_tensors_or_numpy():
    _, tc = CONFIGS["ref_test"]
    batch = _graph("node")
    params = _port_params("ref_test")
    with torch.no_grad():
        a = teq.forward(params, batch, tc)
    b = teq.forward(params, {k: torch.as_tensor(v) for k, v in
                             batch.items()}, tc)
    assert torch.equal(a, b.detach())
    assert not a.requires_grad
