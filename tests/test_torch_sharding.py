"""The port's sharding rules, spec trees, input specs and mesh helpers
(``repro_torch.dist.sharding``, ``models.transformer.param_specs``,
``configs.common``, ``launch.mesh``) against the reference
(``repro.dist.sharding``, ``repro.models.transformer.init``'s spec tree,
``repro.configs.common``), entry for entry; the meta branch of the
attention's plain version; the DTensor helpers on a fake world.

Specs are compared as tuples of entries, exactly. ``sanitize_spec`` reads
only the mesh's axis sizes, so both packages get a duck-typed mesh
(``SimpleNamespace(shape={...})``)."""
import json
import os
import subprocess
import sys
import types
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as rconfigs
from repro.configs import common as rcc
from repro.dist import sharding as rsh
from repro.launch.steps import eval_shape_with_specs
from repro.models import transformer as rtr
from repro.optim import adamw as radamw
from repro_torch import configs, tree
from repro_torch.analysis import shard_lint
from repro_torch.configs import common as cc
from repro_torch.dist import sharding as sh
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw

MULTI = ("pod", "data", "model")
AXES = [MULTI, ("data", "model"), ("data",), ()]
PROFILES = ("2d", "fsdp", "sp", "expert")
LOGICAL = [(None, None), (), ("batch",), ("batch", "model"), ("model", "vocab"),
           ("vocab", "model"), ("fsdp", "model"), ("model", "fsdp"),
           ("batch", "seq", None), ("batch", None, "vocab"),
           ("expert", None, "fsdp"), ("expert", "fsdp", None),
           (None, "batch", "kv_seq", None, None), ("vocab", "fsdp"),
           ("fsdp", "vocab"), ("seq", "model"), ("batch", "vocab")]


def _t(spec):
    return None if spec is None else tuple(spec)


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("axes", AXES)
def test_lm_rules_equal_the_reference(axes, profile):
    """Every logical spec under every profile and mesh resolves to the
    reference's entries: filtering to the mesh, first claim wins, None."""
    r, p = rsh.lm_rules(axes, profile), sh.lm_rules(axes, profile)
    assert p.table == r.table
    for names in LOGICAL:
        assert tuple(p.spec(*names)) == tuple(r.spec(*names)), names


@pytest.mark.parametrize("family", ["gnn", "recsys"])
@pytest.mark.parametrize("axes", AXES)
def test_family_rules_equal_the_reference(family, axes):
    r = getattr(rsh, f"{family}_rules")(axes)
    p = getattr(sh, f"{family}_rules")(axes)
    assert p.table == r.table
    for names in [("rows", None), ("batch", "fsdp"), ("fsdp", "model"),
                  ("rows", "model")] + ([("cand", None)]
                                        if family == "recsys" else []):
        assert tuple(p.spec(*names)) == tuple(r.spec(*names))


def test_rules_contract_cases():
    """The reference's own cases (``tests/test_dist.py``) on the port."""
    r = sh.lm_rules(MULTI)
    assert tuple(r.spec(None, None)) == (None, None)
    assert tuple(r.spec()) == ()
    assert tuple(r.spec("batch")) == (("pod", "data"),)
    assert tuple(sh.lm_rules(("data", "model")).spec("batch")) == ("data",)
    assert all(a is None for a in sh.lm_rules(()).spec("batch", "model"))
    r = sh.lm_rules(("data", "model"))
    assert tuple(r.spec("model", "vocab")) == ("model", None)
    assert tuple(r.spec("vocab", "model")) == ("model", None)
    assert tuple(r.spec("vocab")) == ("model",)
    with pytest.raises(KeyError):
        sh.lm_rules(MULTI).spec("not_an_axis")
    with pytest.raises(KeyError):
        rsh.lm_rules(MULTI).spec("not_an_axis")
    with pytest.raises(ValueError):
        sh.lm_rules(MULTI, profile="3d")
    assert sh.gnn_rules(MULTI).table["rows"] == MULTI
    assert sh.recsys_rules(MULTI).table["cand"] == MULTI
    assert sh.lm_rules(MULTI, "fsdp").table["fsdp"] == ("data", "model")
    assert isinstance(r.spec("batch"), sh.Spec)


def test_shard_is_the_tensor_itself_off_a_mesh():
    """On a plain tensor ``Rules.shard`` returns the tensor itself, under
    the default rules and under a real table alike."""
    x = torch.ones(4, 4)
    assert sh.lm_rules(("data", "model")).shard(x, "batch", "model") is x
    assert sh.NO_MESH.shard(x, "batch", "model") is x


# ---------------------------------------------------------------------------
# sanitize_spec / sanitize_tree
# ---------------------------------------------------------------------------

def _mesh(**sizes):
    return types.SimpleNamespace(shape=dict(sizes))


SANITIZE_CASES = [
    ((7, 8), ("data", "model"), dict(data=4, model=2)),
    ((4, 8), (("data", "model"), None), dict(data=4, model=2)),
    ((16, 8), (("data", "model"), None), dict(data=4, model=2)),
    ((4, 3, 5), ("data",), dict(data=2)),
    ((8,), ("data", "model"), dict(data=2, model=2)),
    ((6, 12), (("pod", "data"), "model"), dict(pod=2, data=4, model=4)),
    ((512, 64), (("pod", "data", "model"), None),
     dict(pod=2, data=16, model=16)),
]


@pytest.mark.parametrize("shape,spec,sizes", SANITIZE_CASES)
def test_sanitize_spec_equals_the_reference(shape, spec, sizes):
    mesh = _mesh(**sizes)
    got = sh.sanitize_spec(shape, sh.Spec(*spec), mesh)
    want = rsh.sanitize_spec(shape, P(*spec), mesh)
    assert tuple(got) == tuple(want)


def test_sanitize_missing_axis_warns_or_raises_as_the_reference():
    mesh = _mesh(data=4, model=2)
    with pytest.warns(UserWarning, match="pod"):
        got = sh.sanitize_spec((8, 8), sh.Spec("pod", "model"), mesh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = rsh.sanitize_spec((8, 8), P("pod", "model"), mesh)
    assert tuple(got) == tuple(want) == (None, "model")
    with pytest.raises(ValueError, match="pod"):
        sh.sanitize_spec((8, 8), sh.Spec("pod", "model"), mesh, strict=True)
    with pytest.raises(ValueError, match="pod"):
        sh.sanitize_tree((cc.sds((8, 8)),), (sh.Spec("pod", None),), mesh,
                         strict=True)
    assert tuple(sh.sanitize_spec((7, 8), sh.Spec("data", "model"), mesh,
                                  strict=True)) == (None, "model")


def test_sanitize_tree_maps_leaves_as_the_reference():
    mesh = _mesh(data=4)
    got = sh.sanitize_tree(
        {"a": cc.sds((8, 3)), "b": cc.sds((7,)), "c": cc.sds((2,))},
        {"a": sh.Spec("data", None), "b": sh.Spec("data"), "c": None}, mesh)
    want = rsh.sanitize_tree(
        {"a": jax.ShapeDtypeStruct((8, 3), np.float32),
         "b": jax.ShapeDtypeStruct((7,), np.float32),
         "c": jax.ShapeDtypeStruct((2,), np.float32)},
        {"a": P("data", None), "b": P("data"), "c": None}, mesh)
    assert {k: _t(v) for k, v in got.items()} == \
        {k: _t(v) for k, v in want.items()}


# ---------------------------------------------------------------------------
# Spec trees
# ---------------------------------------------------------------------------

def _reference_specs_unstacked(spec, cfg):
    """The reference's init spec tree in the port's layout: the stacked
    ``dense_layers`` / ``moe_layers`` unrolled (one entry a layer), each
    leaf's leading stacked ``None`` dropped."""
    out = {k: spec[k] for k in ("embed", "unembed", "ln_f")}
    layers = []
    n_dense = cfg.n_dense_layers if cfg.moe else cfg.n_layers
    for key, n in (("dense_layers", n_dense),
                   ("moe_layers", cfg.n_layers - n_dense)):
        if key in spec:
            per = jax.tree.map(lambda s: P(*tuple(s)[1:]), spec[key],
                               is_leaf=lambda s: isinstance(s, P))
            layers += [per] * n
    return out, layers


CELLS = [("qwen2-1.5b", "full"), ("qwen2-1.5b", "smoke"),
         ("chatglm3-6b", "full"), ("chatglm3-6b", "smoke"),
         ("deepseek-v2-lite-16b", "full"), ("deepseek-v2-lite-16b", "smoke"),
         ("deepseek-v2-236b", "smoke")]


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("name,size", CELLS)
def test_param_specs_equal_the_reference_leaf_for_leaf(name, size, profile):
    """``param_specs`` under the 2x16x16 axes against the spec tree of the
    reference's ``init`` (``eval_shape_with_specs``), leaf for leaf (the
    dense GQA archs, and MoE + MLA, whose ``expert`` dim only the
    ``expert`` profile moves to ``pod``), and lined up with the port's
    params: one spec entry per tensor dim."""
    rarch = rconfigs.get(name)
    rcfg = (rarch.make_config("train_4k") if size == "full"
            else rarch.smoke_config())
    arch = configs.get(name)
    cfg = arch.make_config("train_4k") if size == "full" \
        else arch.smoke_config()
    _, rspec = eval_shape_with_specs(
        lambda k: rtr.init(k, rcfg, rsh.lm_rules(MULTI, profile)),
        jax.random.PRNGKey(0))
    got = tr.param_specs(cfg, sh.lm_rules(MULTI, profile))
    top, per_layer = _reference_specs_unstacked(rspec, rcfg)
    for k in top:
        assert tuple(got[k]) == tuple(top[k]), k
    assert len(got["layers"]) == len(per_layer) == cfg.n_layers
    for layer, want in zip(got["layers"], per_layer):
        flat_got = {path: tuple(s) for path, s in _spec_items(layer)}
        flat_want = {path: tuple(s) for path, s in _spec_items(want)}
        assert flat_got == flat_want
    params = tr.init(cfg, None, device="meta")
    for x, spec in sh.spec_leaves(params, got):
        assert len(spec) == x.dim()


def _spec_items(tree_, prefix=()):
    for k in sorted(tree_):
        v = tree_[k]
        if isinstance(v, dict):
            yield from _spec_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("profile", PROFILES)
def test_cache_specs_equal_the_reference(profile):
    rcfg = rconfigs.get("qwen2-1.5b").smoke_config()
    cfg = configs.get("qwen2-1.5b").smoke_config()
    _, want = eval_shape_with_specs(
        lambda: rtr.init_cache(rcfg, 2, 8, rsh.lm_rules(MULTI, profile)))
    got = tr.cache_specs(cfg, sh.lm_rules(MULTI, profile))
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


def test_state_specs_mirror_the_params():
    pspec = {"w": sh.Spec("data", None), "b": sh.Spec(None)}
    got = adamw.state_specs(pspec)
    want = radamw.state_specs({"w": P("data", None), "b": P(None)})
    assert tuple(got.step) == tuple(want.step) == ()
    assert got.mu == got.nu == pspec
    assert {k: tuple(v) for k, v in want.mu.items()} == \
        {k: tuple(v) for k, v in got.mu.items()}


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------

INPUTS = [("lm_train_inputs", (4, 16)), ("lm_prefill_inputs", (2, 32)),
          ("gnn_train_inputs", (2708, 10556, 1433, 2708)),
          ("gnn_train_inputs", (3840, 16384, 16, 128, True, True)),
          ("recsys_train_inputs", (64, 50, 13)),
          ("recsys_retrieve_inputs", (50, 13, 1000, 64))]


@pytest.mark.parametrize("fn,args", INPUTS)
def test_input_specs_equal_the_reference(fn, args):
    """Shapes, dtypes and logical names of every family's step inputs; the
    port's are meta tensors."""
    got, got_logical = getattr(cc, fn)(*args)
    want, want_logical = getattr(rcc, fn)(*args)
    assert got_logical == want_logical
    assert set(got) == set(want)
    for k, x in got.items():
        assert x.device.type == "meta"
        assert tuple(x.shape) == tuple(want[k].shape)
        assert str(x.dtype).replace("torch.", "") == str(want[k].dtype)
    rules, rrules = sh.lm_rules(MULTI), rsh.lm_rules(MULTI)
    if fn.startswith("lm"):
        assert {k: tuple(v) for k, v in
                cc.logical_to_specs(got_logical, rules).items()} == \
            {k: tuple(v) for k, v in
             rcc.logical_to_specs(want_logical, rrules).items()}
    assert cc.ROW_PAD == rcc.ROW_PAD


def test_all_cells_equal_the_reference():
    got = [(a.name, s.name, s.kind) for a, s in configs.all_cells()]
    want = [(a.name, s.name, s.kind) for a, s in rconfigs.all_cells()]
    assert got == want and len(got) == 40


# ---------------------------------------------------------------------------
# lint_spec_tree
# ---------------------------------------------------------------------------

def test_lint_spec_tree_equals_the_reference():
    """The same findings (check, severity, subject, detail) on a tree with
    an unknown axis, a double claim, a large replicated leaf and a clean
    one."""
    from repro.analysis import shard_lint as rlint
    shapes = {"big": (4096, 4096), "dup": (64, 64), "ok": (64, 64),
              "typo": (64,), "mid": (2048, 4096)}
    specs = {"big": None, "dup": ("data", "data"), "ok": ("data", "model"),
             "typo": ("pdo",), "mid": (None, None)}
    got = shard_lint.lint_spec_tree(
        {k: cc.sds(v) for k, v in shapes.items()},
        {k: None if v is None else sh.Spec(*v) for k, v in specs.items()},
        MULTI, subject="cell")
    want = rlint.lint_spec_tree(
        {k: jax.ShapeDtypeStruct(v, np.float32) for k, v in shapes.items()},
        {k: None if v is None else P(*v) for k, v in specs.items()},
        MULTI, subject="cell")
    assert [(f.check, f.severity, f.subject, f.detail) for f in got] == \
        [(f.check, f.severity, f.subject, f.detail) for f in want]
    assert len(got) == 4


def test_lint_spec_tree_passes_every_lm_profile():
    """The qwen2-1.5b FULL param specs name only mesh axes, claim none
    twice, and replicate nothing large (norms only)."""
    cfg = configs.get("qwen2-1.5b").make_config("train_4k")
    params = tr.init(cfg, None, device="meta")
    for profile in PROFILES:
        found = shard_lint.lint_spec_tree(
            params, tr.param_specs(cfg, sh.lm_rules(MULTI, profile)),
            MULTI, subject=profile)
        assert [f for f in found if f.severity == "error"] == []


# ---------------------------------------------------------------------------
# Meta dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,dv,h,kh", [(128, 128, 12, 2), (192, 128, 16, 16)])
def test_flash_attention_on_meta_returns_shapes_and_computes_nothing(
        d, dv, h, kh):
    q = torch.empty(2, 64, h, d, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 64, kh, d, device="meta", dtype=torch.bfloat16)
    v = torch.empty(2, 64, kh, dv, device="meta", dtype=torch.bfloat16)
    launches = fa.launches
    out = fa.flash_attention(q, k, v)
    o2, lse = fa.kernel_fwd(q, k, v, True, 16, 16)
    assert out.device.type == "meta" and out.shape == (2, 64, h, dv)
    assert o2.shape == (2, 64, h, dv) and lse.shape == (2, 64, h)
    assert lse.dtype == torch.float32 and out.dtype == torch.bfloat16
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = fa.attention(qg, kg, vg)
    dq, dk, dv_ = torch.autograd.grad(o.float().sum(), [qg, kg, vg])
    assert (dq.shape, dk.shape, dv_.shape) == (q.shape, k.shape, v.shape)
    assert fa.launches == launches


def test_flash_attention_on_cpu_is_the_plain_version_bitwise():
    """The meta branch leaves the CPU path as it was: the dispatch's CPU
    result is the plain forward's, bit for bit."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 40, n, 16, generator=g) for n in (4, 2, 2))
    from repro_torch.models.common import flash_attention_fwd
    got, lse = fa.flash_attention(q, k, v, q_chunk=16, kv_chunk=8,
                                  return_lse=True)
    want, want_lse = flash_attention_fwd(q, k, v, True, 16, 8)
    assert torch.equal(got, want) and torch.equal(lse, want_lse)


def test_cross_entropy_on_meta_is_shaped():
    from repro_torch.models.common import cross_entropy
    logits = torch.empty(2, 8, 50, device="meta", requires_grad=True)
    labels = torch.empty(2, 8, device="meta", dtype=torch.int64)
    loss = cross_entropy(logits, labels)
    (g,) = torch.autograd.grad(loss, [logits])
    assert loss.shape == () and g.shape == logits.shape


# ---------------------------------------------------------------------------
# The DTensor helpers and the fake world
# ---------------------------------------------------------------------------

def test_helpers_on_plain_tensors_are_the_plain_ops_bitwise():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 24, generator=g)
    w = torch.randn(24, 7, generator=g)
    assert torch.equal(sh.dense(x, w), x @ w)
    assert torch.equal(sh.split_last(x, 2, 12), x.reshape(2, 5, 2, 12))
    y = x.reshape(2, 5, 2, 12)
    assert torch.equal(sh.merge_last(y), x)
    table = torch.randn(11, 6, generator=g)
    ids = torch.tensor([[1, 4], [10, 0]])
    assert torch.equal(sh.embed_rows(table, ids), table[ids])


def test_fake_world_tears_down_and_refuses_nesting():
    import torch.distributed as dist
    with mesh_lib.fake_world(8) as n:
        assert n == 8 and dist.get_world_size() == 8
        with pytest.raises(RuntimeError, match="already up"):
            with mesh_lib.fake_world(4):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with mesh_lib.fake_world(4):
            1 / 0
    assert not dist.is_initialized()


def test_mapped_mesh_checks_as_the_reference():
    with mesh_lib.fake_world(8):
        m = mesh_lib.make_mapped_mesh((2, 4), ("data", "model"),
                                      np.arange(8)[::-1])
        assert mesh_lib.device_order_of(m).tolist() == list(range(8))[::-1]
        with pytest.raises(ValueError, match="permutation"):
            mesh_lib.make_mapped_mesh((2, 4), ("data", "model"),
                                      np.zeros(8, int))
        with pytest.raises(ValueError, match=r"needs 16 devices, got 8"):
            mesh_lib.make_mapped_mesh((4, 4), ("data", "model"))
        assert mesh_lib.make_smoke_mesh().shape == (8,)


def test_helpers_on_dtensors_split_heads_that_do_not_divide():
    """Two heads over a 4-way model axis: the split gathers the head dim
    first (DTensor refuses the uneven split); merge's backward splits the
    gradient the same way."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with mesh_lib.fake_world(8):
        mesh = mesh_lib.make_mapped_mesh((2, 4), ("data", "model"))
        x = DTensor.from_local(torch.empty(1, 3, 6, device="meta"), mesh,
                               [Shard(0), Shard(2)], run_check=False)
        y = sh.split_last(x, 2, 12)
        assert y.shape == (2, 3, 2, 12)
        assert tuple(y.placements) == (Shard(0), Replicate())
        z = sh.merge_last(y.detach().requires_grad_(True))
        assert z.shape == (2, 3, 24)


NESTING = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
pos = {d: i for i, d in enumerate(mesh.devices.ravel())}
x = np.arange(32)
out = {}
for name, spec in (("both", P(("data", "model"))), ("data", P("data"))):
    m = NamedSharding(mesh, spec).devices_indices_map((32,))
    out[name] = {pos[d]: x[i].tolist() for d, i in m.items()}
print(json.dumps(out))
"""


def test_two_axis_shards_nest_as_jax_nests_them():
    """A dim named over ("data", "model") is data-major in JAX (the
    first-named axis outermost); the port's placements give each mesh
    position the same slice of a global ``arange`` (rank 0 sits at each
    position in turn: the fake world runs one rank)."""
    from torch.distributed.tensor import distribute_tensor
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", NESTING], env=env,
                         capture_output=True, text=True, check=True)
    want = json.loads(out.stdout.strip().splitlines()[-1])
    x = torch.arange(32)
    for name, spec in (("both", sh.Spec(("data", "model"))),
                       ("data", sh.Spec("data"))):
        for p in range(8):
            order = np.roll(np.arange(8), p)       # rank 0 at position p
            with mesh_lib.fake_world(8):
                mesh = mesh_lib.make_mapped_mesh((2, 4), ("data", "model"),
                                                 order)
                local = distribute_tensor(x, mesh, sh.placements(mesh, spec),
                                          src_data_rank=None).to_local()
            assert local.tolist() == want[name][str(p)], (name, p)


def test_placements_refuse_axes_out_of_mesh_order():
    with mesh_lib.fake_world(8):
        mesh = mesh_lib.make_mapped_mesh((2, 4), ("data", "model"))
        with pytest.raises(ValueError, match="order"):
            sh.placements(mesh, sh.Spec(("model", "data")))


def test_spec_leaves_walk_the_port_trees():
    cfg = configs.get("qwen2-1.5b").smoke_config()
    params = tr.init(cfg, None, device="meta")
    pspec = tr.param_specs(cfg, sh.lm_rules(MULTI))
    pairs = sh.spec_leaves(params, pspec)
    assert len(pairs) == len(tree.leaves(params))
    state = adamw.init(params, adamw.AdamWConfig())
    pairs = sh.spec_leaves(state, adamw.state_specs(pspec))
    assert len(pairs) == len(tree.leaves(state))
    assert pairs[0][1] == sh.Spec()


def test_only_fake_world_starts_a_process_group():
    """No module of the port, and not ``chip_smoke.py``, calls
    ``init_process_group`` but ``launch/mesh.py``'s ``fake_world`` and
    ``init_world`` (the world ``torchrun`` describes, or a forced one-rank
    world)."""
    import ast
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    calls = []
    for path in sorted((root / "src" / "repro_torch").rglob("*.py")) + [
            root / "chip_smoke.py"]:
        tree_ = ast.parse(path.read_text())
        owner = {}
        for fn in ast.walk(tree_):
            if isinstance(fn, ast.FunctionDef):
                for node in ast.walk(fn):
                    owner.setdefault(node, fn.name)
        for node in ast.walk(tree_):
            if (isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", None))
                    == "init_process_group"):
                calls.append((path.name, owner.get(node, "")))
    assert sorted(set(calls)) == [("mesh.py", "fake_world"),
                                  ("mesh.py", "init_world")]
