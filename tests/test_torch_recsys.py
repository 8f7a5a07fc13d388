"""Port parity for the two-tower serving path: the recsys data stream, the
configs, the MLP block and ``TwoTower`` against the reference on the same
numpy inputs and parameters (carried across by
``interop.recsys_params_from``); the row-permutation transparency and the
fused-lookup agreement bitwise inside the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.configs import two_tower_retrieval as jtt
from repro.data import pipeline as jpipeline
from repro.dist.sharding import recsys_rules
from repro.models import gnn as jgnn
from repro.models import recsys as jrecsys
from repro_torch import interop
from repro_torch.configs import common as tcommon
from repro_torch.configs import two_tower_retrieval as ttt
from repro_torch.data import pipeline as tpipeline
from repro_torch.embed import ShardedEmbeddingTable, identity_plan
from repro_torch.embed.sharded_table import ShardPlan
from repro_torch.kernels import ops
from repro_torch.models import recsys as trecsys
from repro_torch.models.mlp import MLP

torch.set_num_threads(1)

# float32 towers: two GEMM stacks summing in different orders
TOWER_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_recsys_batches_are_the_reference_exactly(seed):
    ref = jpipeline.recsys_batches(2000, 30, batch=64, hist_len=12,
                                   d_dense=4, seed=seed)
    got = tpipeline.recsys_batches(2000, 30, batch=64, hist_len=12,
                                   d_dense=4, seed=seed)
    cats = tpipeline.item_categories(2000, 30, seed=seed)
    for _ in range(3):
        a, b = next(ref), next(got)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(cats[b["item_id"]], b["item_cat"])


def test_configs_and_shape_grid_are_the_reference():
    for name in ("FULL", "SMOKE"):
        a, b = getattr(jtt, name), getattr(ttt, name)
        for f in ("name", "n_items", "n_cats", "embed_dim", "tower_mlp",
                  "hist_len", "d_dense"):
            assert getattr(a, f) == getattr(b, f), (name, f)
        assert b.dtype == torch.float32
    ref, got = jcommon.recsys_shape_grid(), tcommon.recsys_shape_grid()
    assert ref.keys() == got.keys()
    for k in ref:
        assert (ref[k].name, ref[k].kind, ref[k].meta) == \
            (got[k].name, got[k].kind, got[k].meta)
    a, b = jtt.smoke_batch(), ttt.smoke_batch()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("layer_norm", [False, True])
def test_mlp_matches_mlp_apply(layer_norm):
    dims = (20, 48, 32, 8)
    p = jgnn.mlp_init(jax.random.PRNGKey(1), dims, jnp.float32,
                      layer_norm=layer_norm)
    if layer_norm:   # a non-trivial scale
        p["ln"] = jnp.linspace(0.5, 1.5, dims[-1])
    x = np.random.default_rng(1).normal(0, 1, (16, 20)).astype(np.float32)
    want = np.asarray(jgnn.mlp_apply(p, jnp.asarray(x)))
    mlp = MLP(dims, layer_norm=layer_norm, device="cpu")
    state = {f"{f}.{i}": torch.from_numpy(np.array(a))
             for f in ("w", "b") for i, a in enumerate(p[f])}
    if layer_norm:
        state["ln"] = torch.from_numpy(np.array(p["ln"]))
    mlp.load_state_dict(state)
    got = mlp(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOWER_TOL)


def test_mlp_init_scale_and_layout():
    gen = torch.Generator().manual_seed(0)
    mlp = MLP((400, 300, 2), generator=gen, device="cpu")
    assert [tuple(w.shape) for w in mlp.w] == [(400, 300), (300, 2)]
    assert abs(float(mlp.w[0].detach().std()) - 400 ** -0.5) < 0.05 * 400 ** -0.5
    assert all(float(b.detach().abs().max()) == 0.0 for b in mlp.b)
    assert mlp.ln is None


def _reference_model(cfg):
    rules = recsys_rules(())
    params, _ = jrecsys.init(jax.random.PRNGKey(0), cfg, rules)
    return params, rules


def _port_model(params):
    model = trecsys.TwoTower(ttt.SMOKE, device="meta")
    model.load_state_dict(interop.recsys_params_from(
        jax.tree_util.tree_map(np.asarray, params)), assign=True)
    return model


def test_two_tower_state_and_init():
    gen = torch.Generator().manual_seed(0)
    model = trecsys.TwoTower(ttt.SMOKE, generator=gen, device="cpu")
    params, _ = _reference_model(jtt.SMOKE)
    state = interop.recsys_params_from(
        jax.tree_util.tree_map(np.asarray, params))
    own = model.state_dict()
    assert own.keys() == state.keys()
    for k in own:
        assert own[k].shape == state[k].shape, k
    # 1000 items stay 1000 rows on one card; 50 categories pad to 56
    assert model.item_table.shape[0] == 1000
    assert model.cat_table.shape[0] == trecsys._row_pad(50) == 56
    assert abs(float(model.item_table.std()) - 0.01) < 1e-3
    again = trecsys.TwoTower(ttt.SMOKE, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(own[k], again.state_dict()[k]) for k in own)


@pytest.mark.parametrize("n,m,want", [(1_000_000, 8, 1_000_000), (7, 8, 8),
                                      (50, 8, 56), (13, 4, 16)])
def test_row_pad(n, m, want):
    assert trecsys._row_pad(n, m) == want


def test_two_tower_serving_matches_reference():
    cfg = jtt.SMOKE
    params, rules = _reference_model(cfg)
    model = _port_model(params)
    batch = ttt.smoke_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for fn in ("user_embed", "item_embed", "score"):
        want = np.asarray(getattr(jrecsys, fn)(params, jb, cfg, rules))
        got = getattr(model, fn)(batch).numpy()
        assert got.shape == want.shape, fn
        np.testing.assert_allclose(got, want, err_msg=fn, **TOWER_TOL)


def test_retrieve_matches_reference():
    cfg = jtt.SMOKE
    params, rules = _reference_model(cfg)
    model = _port_model(params)
    batch = ttt.smoke_batch()
    cand = np.random.default_rng(2).normal(
        0, 1, (512, cfg.embed_dim)).astype(np.float32)
    q = {"user_hist": batch["user_hist"][:1],
         "user_dense": batch["user_dense"][:1], "cand_emb": cand}
    jv, ji = jrecsys.retrieve(params, {k: jnp.asarray(v)
                                       for k, v in q.items()},
                              cfg, rules, top_k=32)
    tv, ti = model.retrieve(q, top_k=32)
    jv, ji, tv, ti = map(np.asarray, (jv, ji, tv, ti))
    np.testing.assert_allclose(tv, jv, **TOWER_TOL)
    # ties may be ordered differently; outside them the sets agree
    tied = np.isclose(jv[:, None], jv[None, :], rtol=1e-5, atol=1e-6).sum(1)
    assert set(ti[tied == 1]) == set(ji[tied == 1])
    assert (np.diff(tv) <= 0).all()


def _perm_plan(n, seed=0):
    order = np.random.default_rng(seed).permutation(n)
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    plan0 = identity_plan(n, 1)
    return ShardPlan(row_to_device=plan0.row_to_device, n_devices=1,
                     order=order, perm=perm, offsets=plan0.offsets,
                     makespan=0.0)


def test_row_perm_is_transparent_bitwise():
    """user/item embeddings and scores through a permuted table +
    ``row_perm`` equal the unpermuted model's bitwise (the reference's
    ``test_recsys_row_perm_is_transparent``), and the permuted table's
    fused ``lookup_bags`` equals ``embedding_bag`` on the original."""
    gen = torch.Generator().manual_seed(3)
    model = trecsys.TwoTower(ttt.SMOKE, generator=gen, device="cpu")
    plan = _perm_plan(model.item_table.shape[0])
    st = ShardedEmbeddingTable(model.item_table, plan)
    permuted = trecsys.TwoTower(ttt.SMOKE, device="meta")
    permuted.load_state_dict({**model.state_dict(), "item_table": st.data},
                             assign=True)
    row_perm = torch.from_numpy(plan.perm)
    batch = ttt.smoke_batch()
    for fn in ("user_embed", "item_embed", "score"):
        a = getattr(model, fn)(batch)
        b = getattr(permuted, fn)(batch, row_perm=row_perm)
        assert torch.equal(a, b), fn
    ids = torch.from_numpy(batch["user_hist"])
    valid = (ids >= 0).float()
    w = valid / valid.sum(-1, keepdim=True).clamp_min(1)
    assert torch.equal(st.lookup_bags(ids, w),
                       ops.embedding_bag(model.item_table.detach(),
                                         ids.clamp_min(0), w))


def test_serving_requires_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trecsys.TwoTower(ttt.SMOKE)
