"""Port parity for the GIN slice: the GNN data pipeline, shape grid and
configs exactly; ``cross_entropy`` and ``edge_apply`` (direct and chunked);
and the GIN forward and loss through the BSR aggregation against the
reference's ``gnn.forward`` / ``gnn.loss_fn`` (``segment_sum`` aggregation)
with the reference's parameters carried across by
``interop.gnn_params_from``, all on the same numpy inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.configs import gin_tu as jgin
from repro.data import pipeline as jpipeline
from repro.dist.sharding import gnn_rules
from repro.graph import generators as jgen
from repro.models import common as jmcommon
from repro.models import gnn as jgnn
from repro_torch import interop
from repro_torch.configs import common as tcommon
from repro_torch.configs import gin_tu as tgin
from repro_torch.data import pipeline as tpipeline
from repro_torch.graph import generators as tgen
from repro_torch.kernels import ops
from repro_torch.models import common as tmcommon
from repro_torch.models import gnn as tgnn

torch.set_num_threads(1)
RULES = gnn_rules(())

# Logits: float32 sums taken in other orders (the BSR block products against
# segment_sum, other GEMM blockings), compounded over up to 5 sum
# aggregations whose values grow to ~1e3; measured 2.8e-7 of the largest
# logit at 5 layers x 64, so 1e-5 of it (and of each value) leaves 30x room.
GIN_RTOL = 1e-5


def _assert_logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    err = np.abs(got - want)
    assert np.all(err <= GIN_RTOL * (scale + np.abs(want))), \
        (float(err.max()), scale)


def _assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("with_pos", [False, True])
@pytest.mark.parametrize("gen", ["rmat", "molecules"])
def test_gnn_features_are_the_reference_exactly(gen, with_pos):
    if gen == "rmat":
        jg, tg = jgen.rmat(700, 3000, seed=3), tgen.rmat(700, 3000, seed=3)
    else:
        jg = jgen.molecule_batch(6, 30, 64, seed=1)
        tg = tgen.molecule_batch(6, 30, 64, seed=1)
    _assert_batches_equal(
        jpipeline.gnn_features(jg, 16, 3, seed=2, with_pos=with_pos),
        tpipeline.gnn_features(tg, 16, 3, seed=2, with_pos=with_pos))


@pytest.mark.parametrize("seed", [0, 5])
def test_molecule_batches_are_the_reference_exactly(seed):
    ref = jpipeline.molecule_batches(12, 30, 64, 16, 2, seed=seed)
    got = tpipeline.molecule_batches(12, 30, 64, 16, 2, seed=seed)
    for _ in range(3):
        _assert_batches_equal(next(ref), next(got))


@pytest.mark.parametrize("kw", [{}, {"graphs": 8, "with_pos": True},
                                {"n": 40, "deg": 3, "d_feat": 5, "seed": 2}])
def test_smoke_gnn_batch_is_the_reference_exactly(kw):
    _assert_batches_equal(jcommon.smoke_gnn_batch(**kw),
                          tcommon.smoke_gnn_batch(**kw))


def test_gnn_shape_grid_and_gin_configs_are_the_reference():
    ref, got = jcommon.gnn_shape_grid(), tcommon.gnn_shape_grid()
    assert ref.keys() == got.keys()
    for k in ref:
        assert (ref[k].name, ref[k].kind, ref[k].meta) == \
            (got[k].name, got[k].kind, got[k].meta)
    fields = [f.name for f in dataclasses.fields(tgnn.GNNConfig)
              if f.name != "dtype"]
    for name in ("BASE", "SMOKE"):
        a, b = getattr(jgin, name), getattr(tgin, name)
        assert [getattr(a, f) for f in fields] == \
            [getattr(b, f) for f in fields], name
        assert b.dtype == torch.float32
    for shape in ref:
        a, b = jgin.ARCH.make_config(shape), tgin.ARCH.make_config(shape)
        assert [getattr(a, f) for f in fields] == \
            [getattr(b, f) for f in fields], shape
        assert jgin.ARCH.model_flops(shape) == tgin.ARCH.model_flops(shape)
    mol = tgin.ARCH.make_config("molecule")
    assert (mol.d_in, mol.n_classes, mol.graph_level, mol.edge_chunk) == \
        (16, 2, True, 0)
    assert (tgin.ARCH.name, tgin.ARCH.family) == ("gin-tu", "gnn")
    _assert_batches_equal(jgin.ARCH.smoke_batch(), tgin.ARCH.smoke_batch())


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_the_reference(masked):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (4, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (4, 7)).astype(np.int32)
    mask = (rng.random((4, 7)) > 0.3).astype(np.float32) if masked else None
    want = float(jmcommon.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask)))
    got = float(tmcommon.cross_entropy(
        torch.as_tensor(logits), torch.as_tensor(labels),
        None if mask is None else torch.as_tensor(mask)))
    assert got == pytest.approx(want, rel=1e-6)


def _msg_fns():
    w = np.random.default_rng(9).normal(size=(12, 12)).astype(np.float32)

    def jfn(xd, xs, e=None):
        m = jnp.tanh(xd @ jnp.asarray(w)) * xs
        return m if e is None else m * e

    def tfn(xd, xs, e=None):
        m = torch.tanh(xd @ torch.as_tensor(w)) * xs
        return m if e is None else m * e
    return jfn, tfn


@pytest.mark.parametrize("with_extra", [False, True])
@pytest.mark.parametrize("chunk", [0, 100_000, 256, 97])
def test_edge_apply_matches_the_reference(chunk, with_extra):
    """Direct (chunk 0 or larger than E) and chunked, 97 leaving a ragged
    last chunk."""
    g = tgen.rmat(300, 1200, seed=4)
    assert g.n_arcs % 97 and g.n_arcs > 256
    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, 12)).astype(np.float32)
    extra = (rng.normal(size=(g.n_arcs, 1)).astype(np.float32)
             if with_extra else None)
    jfn, tfn = _msg_fns()
    want = np.asarray(jgnn.edge_apply(
        jnp.asarray(g.senders), jnp.asarray(g.receivers), jfn,
        jnp.asarray(x), 300, 12, chunk=chunk,
        extra=None if extra is None else jnp.asarray(extra)))
    got = tgnn.edge_apply(
        torch.as_tensor(g.senders), torch.as_tensor(g.receivers), tfn,
        torch.as_tensor(x), 300, 12, chunk=chunk,
        extra=None if extra is None else torch.as_tensor(extra))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _models(cfg_j, cfg_t, eps=None, seed=0):
    params, _ = jgnn.init(jax.random.PRNGKey(seed), cfg_j, RULES)
    if eps is not None:
        params["layers"]["eps"] = jnp.asarray(eps, jnp.float32)
    model = tgnn.GIN(cfg_t, device="meta")
    model.load_state_dict(interop.gnn_params_from(params), assign=True)
    return params, model


def _reference(params, batch, cfg):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return (np.asarray(jgnn.forward(params, jb, cfg, RULES)),
            float(jgnn.loss_fn(params, jb, cfg, RULES)[0]))


def _cases():
    five = dict(n_layers=5, d_hidden=64, d_in=16, n_classes=2)
    return {
        "smoke_node": (jgin.SMOKE, tgin.SMOKE,
                       lambda: tcommon.smoke_gnn_batch(d_feat=8, n_classes=4),
                       None),
        "smoke_graph": (dataclasses.replace(jgin.SMOKE, graph_level=True),
                        dataclasses.replace(tgin.SMOKE, graph_level=True),
                        lambda: tcommon.smoke_gnn_batch(d_feat=8, n_classes=4,
                                                        graphs=8),
                        [0.25, -0.1]),
        "gin5x64_molecules": (jgin.ARCH.make_config("molecule"),
                              tgin.ARCH.make_config("molecule"),
                              lambda: next(tpipeline.molecule_batches(
                                  8, 30, 64, 16, 2, seed=0)),
                              np.linspace(-0.3, 0.4, 5)),
        "gin5x64_node_rmat": (
            dataclasses.replace(jgin.BASE, **five),
            dataclasses.replace(tgin.BASE, **five),
            lambda: tpipeline.gnn_features(tgen.rmat(300, 1500, seed=3), 16,
                                           2, seed=0),
            [0.1, 0.0, -0.2, 0.3, 0.05]),
    }


CASES = _cases()


@pytest.mark.parametrize("block", [128, 32])
@pytest.mark.parametrize("name", sorted(CASES))
def test_gin_forward_and_loss_match_the_reference(name, block):
    cfg_j, cfg_t, make_batch, eps = CASES[name]
    batch = make_batch()
    params, model = _models(cfg_j, cfg_t, eps)
    want, want_loss = _reference(params, batch, cfg_j)
    layout = tgnn.gin_layout(batch, block=block, device="cpu")
    got = model(batch, layout)
    assert got.shape == want.shape
    _assert_logits_close(got.numpy(), want)
    assert float(model.loss(batch, layout)) == pytest.approx(want_loss,
                                                             rel=GIN_RTOL)
    # the same forward on the reference's segment_sum formulation
    s, r = torch.as_tensor(batch["senders"]), torch.as_tensor(batch["receivers"])
    ones = torch.ones(s.shape[0])
    seg = model.forward_with(
        batch, lambda x: ops.gnn_aggregate(s, r, ones, x, x.shape[0]))
    _assert_logits_close(seg.numpy(), want)


def test_gin_ignores_edge_weight_as_the_reference_does():
    cfg_j, cfg_t, make_batch, eps = CASES["smoke_node"]
    batch = make_batch()
    batch["edge_weight"] = np.random.default_rng(1).random(
        batch["senders"].shape[0]).astype(np.float32) + 0.5
    params, model = _models(cfg_j, cfg_t, eps)
    want, _ = _reference(params, batch, cfg_j)
    _assert_logits_close(model(batch, tgnn.gin_layout(batch, device="cpu")),
                         want)


def test_gnn_params_from_unstacks_the_layers():
    params, model = _models(jgin.SMOKE, tgin.SMOKE, [0.5, -0.25])
    state = interop.gnn_params_from(params)
    assert set(state) == set(model.state_dict())
    assert float(model.layers[1].eps.detach()) == -0.25
    np.testing.assert_array_equal(
        model.layers[1].mlp.w[0].detach().numpy(),
        np.asarray(params["layers"]["mlp"]["w"][0][1]))


def test_gin_from_a_seed_runs_on_the_cpu():
    gen = torch.Generator().manual_seed(0)
    cfg = tgin.ARCH.make_config("molecule")
    model = tgnn.GIN(cfg, generator=gen, device="cpu")
    assert len(model.layers) == 5 and model.decode.w[1].shape == (64, 2)
    batch = next(tpipeline.molecule_batches(4, 30, 64, 16, 2, seed=1))
    logits = model(batch, tgnn.gin_layout(batch, device="cpu"))
    assert logits.shape == (4, 2) and bool(torch.isfinite(logits).all())
    assert not logits.requires_grad


@pytest.mark.parametrize("kind", ["pna", "mgn"])
def test_other_gnn_kinds_raise(kind):
    """The GIN serving module refuses the other kinds, which run through
    the functional ``init`` / ``forward`` / ``loss_fn``."""
    with pytest.raises(ValueError, match="GIN runs GNN kind 'gin'"):
        tgnn.GIN(dataclasses.replace(tgin.SMOKE, kind=kind), device="cpu")


def test_forward_needs_the_batchs_layout():
    model = tgnn.GIN(tgin.SMOKE, device="cpu")
    batch = tcommon.smoke_gnn_batch(d_feat=8, n_classes=4)
    with pytest.raises(ValueError, match="BSR layout"):
        model(batch, None)
    other = tcommon.smoke_gnn_batch(n=40, d_feat=8, n_classes=4)
    with pytest.raises(ValueError, match="40 nodes"):
        model(batch, tgnn.gin_layout(other, device="cpu"))
