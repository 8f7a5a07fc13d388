"""The port's traced cells against the reference's compiled ones: the
DeepSeek-V2-Lite MoE + MLA cell on both MoE routes (the default GSPMD-like
dispatch and ``ep_shard_map``'s expert-parallel body), one cell of each
GNN, the two-tower model's train / score / retrieve cells and
``grad_compress`` on qwen2, each on a (2, 4) mesh at tiny overrides. The
reference compiles each with XLA on 8 host devices in a subprocess (the
``REFERENCE_RECORD`` pattern of ``tests/test_torch_placement.py``). Also
the GNN, EquiformerV2 and two-tower spec trees against the reference's
``init``, the expert-parallel route bitwise on one device, the chunked
EquiformerV2 trace, and the compression round trip over DeepSeek's two
layer stacks.

Bytes: the reference's records (``link_bf16`` and its traffic matrix)
halve every float32 collective (XLA:CPU upcasts bf16 products); the
port's count a collective at its dtype's bytes. The GNNs and the
two-tower model are float32 throughout, so their reference bytes are
doubled back before the comparison (``_F32``)."""
import collections
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as rconfigs
from repro.dist import sharding as rsh
from repro.launch.steps import eval_shape_with_specs
from repro_torch import configs, tree
from repro_torch.dist import sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import placement as pl
from repro_torch.launch.steps import build_cell, rules_for

DS = {"n_layers": 2, "batch": 2, "seq": 8}
QWEN = {"n_layers": 1, "batch": 2, "seq": 8}
GRAPH = {"n": 1024, "arcs": 2048}
CELLS = {
    "ds_2d": ["deepseek-v2-lite-16b", "train_4k", "2d", DS],
    "ds_expert": ["deepseek-v2-lite-16b", "train_4k", "expert", DS],
    "ds_2d_noremat": ["deepseek-v2-lite-16b", "train_4k", "2d",
                      dict(DS, remat=False), False, True],
    "ds_ep": ["deepseek-v2-lite-16b", "train_4k", "2d",
              dict(DS, remat=False, ep_shard_map=1), False, True],
    "gin": ["gin-tu", "molecule", "2d", {}],
    "pna": ["pna", "minibatch_lg", "2d", GRAPH],
    "mgn": ["meshgraphnet", "full_graph_sm", "2d", GRAPH],
    "eq": ["equiformer-v2", "molecule", "2d",
           {"n_layers": 1, "channels": 16, "l_max": 2}],
    "tt_train": ["two-tower-retrieval", "train_batch", "2d", {"batch": 64}],
    "tt_score": ["two-tower-retrieval", "serve_p99", "2d", {"batch": 64}],
    "tt_retrieve": ["two-tower-retrieval", "retrieval_cand", "2d",
                    {"n_cand": 4096}],
    "q": ["qwen2-1.5b", "train_4k", "2d", QWEN, False, True],
    "q_gc": ["qwen2-1.5b", "train_4k", "2d", QWEN, True, True],
}
_F32 = {"gin", "pna", "mgn", "eq", "tt_train", "tt_score", "tt_retrieve"}

REFERENCE_RECORDS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from repro import configs
from repro.dist.sharding import sanitize_tree, tree_shardings
from repro.launch import collectives as C
from repro.launch.mesh import make_mapped_mesh
from repro.launch.steps import build_cell, rules_for

def record(arch, shape, profile, overrides, gc=False, detail=False):
    a = configs.get(arch)
    mesh = make_mapped_mesh((2, 4), ("data", "model"), None)
    rules = rules_for(a.family, mesh.axis_names, profile=profile)
    cell = build_cell(a, a.shapes[shape], rules, grad_compress=gc,
                      overrides=overrides)
    specs = tuple(sanitize_tree(s, sp, mesh) for s, sp in
                  zip(cell["args_sds"], cell["args_specs"]))
    with mesh:
        hlo = jax.jit(cell["step"], in_shardings=tuple(
            tree_shardings(mesh, s) for s in specs)).lower(
                *cell["args_sds"]).compile().as_text()
    c = C.parse_collectives(hlo, 8, cell["scan_lengths"], traffic=True)
    out = {"link_bf16": c["link_bf16"], "traffic": c["traffic"].tolist()}
    if detail:      # every collective line: op, result bytes, groups
        out["collectives"] = []
        for line in hlo.splitlines():
            m = C._RESULT_RE.search(line.strip())
            if m and m.group(3) != "-done":
                g = C.materialize_groups(line, 8)
                out["collectives"].append([
                    m.group(2), C._shape_bytes(m.group(1),
                                               m.group(3) == "-start"),
                    None if g is None else g.tolist()])
    return out

print(json.dumps({k: record(*v) for k, v in json.loads(sys.argv[1]).items()}))
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", REFERENCE_RECORDS,
                          json.dumps(CELLS)], env=env, capture_output=True,
                         text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


SESSION = pl.PlacementSession(cache_dir="", map_restarts=2, device="cpu")


def _port(name):
    arch, shape, profile, over = CELLS[name][:4]
    gc = CELLS[name][4] if len(CELLS[name]) > 4 else False
    return SESSION.measure(arch, shape, mesh_shape=(2, 4),
                           axes=("data", "model"), profile=profile,
                           grad_compress=gc, overrides=over)


def _records(name, grad_compress=None):
    """The port's collective records of a cell, one trace (not cached)."""
    arch_name, shape, profile, over = CELLS[name][:4]
    gc = CELLS[name][4] if len(CELLS[name]) > 4 else False
    arch = configs.get(arch_name)
    with mesh_lib.fake_world(8):
        mesh = mesh_lib.make_mapped_mesh((2, 4), ("data", "model"), None)
        cell = build_cell(arch, arch.shapes[shape],
                          rules_for(arch.family, ("data", "model"), profile),
                          grad_compress=gc, overrides=over)
        args = tuple(pl.meta_dtensors(a, s, mesh)
                     for a, s in zip(cell["args"], cell["args_specs"]))
        rec, _, _ = pl.trace_step(cell["step"], args, mesh)
    return rec.records


COORDS = np.argwhere(np.ones((2, 4)))


def _pair_axis(i, j):
    d = COORDS[i] != COORDS[j]
    return "both" if d.all() else ("data" if d[0] else "model")


def _axis_bytes(T):
    """Link bytes of the device pairs that differ along one mesh axis only,
    by axis, and of those that differ along both ("both": a ring over the
    (data, model) product, which XLA forms and DTensor's nested rings do
    not)."""
    T = np.asarray(T)
    out = {"data": 0.0, "model": 0.0, "both": 0.0}
    for i in range(8):
        for j in range(i + 1, 8):
            out[_pair_axis(i, j)] += float(T[i, j])
    return out


def _ref_traffic(ref, name):
    t = np.asarray(ref[name]["traffic"])
    return 2.0 * t if name in _F32 else t


# ---------------------------------------------------------------------------
# Device pairs
# ---------------------------------------------------------------------------

# the share of the reference's bytes on pairs the port never pairs. Every
# such pair differs along both mesh axes (XLA's rings over the (data,
# model) product and its permutes across both), except in gin and eq, where
# XLA's iota groups also pair model coordinates two apart ({0, 2}, {1, 3})
# to gather the row-sharded node features in two steps
REF_ONLY_SHARE = {"ds_2d": 0.02, "ds_expert": 0.02, "ds_ep": 0.01,
                  "gin": 0.25, "pna": 0.12, "mgn": 0.08, "eq": 0.27,
                  "tt_train": 0.06, "tt_score": 0.12, "tt_retrieve": 0.21,
                  "q": 1e-12, "q_gc": 1e-12}


@pytest.mark.parametrize("name", sorted(REF_ONLY_SHARE))
def test_the_port_pairs_devices_the_reference_pairs(ref, name):
    got, want = _port(name).traffic > 0, _ref_traffic(ref, name)
    assert not (got & ~(want > 0)).any()
    only = (want > 0) & ~got
    assert want[only].sum() <= REF_ONLY_SHARE[name] * want.sum()
    if name not in ("gin", "eq"):
        assert all(_pair_axis(i, j) == "both" for i, j in np.argwhere(only))


# ---------------------------------------------------------------------------
# Link bytes by axis (LM cells) and in total (float32 families)
# ---------------------------------------------------------------------------

# DeepSeek-V2-Lite, port over reference, in link bytes a device. The data
# axis (2d 0.63, expert route 0.81) is the qwen2 cell's story
# (tests/test_torch_placement.py, AXIS_BAND): the port reduce-scatters each
# gradient once, bf16, to its parameter's shards (the embedding's and the
# unembedding's [25,600, 2,048] shards 52.4 MB each, the experts'
# [16, 1,408, 2,048] 5.8 MB) where XLA all-reduces them, and gathers each
# FSDP weight once where XLA gathers the unembedding and the dense FFN's
# again for the backward; under ep_shard_map both gather the experts'
# weights over data in the body ([16, 2,048, 1,408] three times) and
# reduce-scatter their gradients, so the share rises. The model axis is
# held against the reference's model axis plus its (data, model) product
# rings, since XLA reduces the MoE dispatch rows ([96, 2,048], u32 and f32)
# and the router's logits over all 8 devices where DTensor reduces and
# gathers one axis at a time: 2d 1.04, expert route 0.99; the port gathers
# the expert outputs [64, 8, 2,048] over model for the combine (its dispatch
# is replicated, GSPMD's replicated buffers), XLA reduces the gathered
# rows. qwen2 with grad_compress: the compression's gathers are float32 in
# both (the reference's halving undercounts its own), data 0.89 over 0.65
# without it, the model axis 2.00: the unembedding's [768, 151,936] and the
# FFN's gathers over model are equal in bytes (test below), XLA's halving
# counts them at half.
LM_BAND = {"ds_2d": {"data": (0.55, 0.70), "model": (0.9, 1.2)},
           "ds_expert": {"data": (0.55, 0.70), "model": (0.9, 1.2)},
           "ds_ep": {"data": (0.72, 0.90), "model": (0.85, 1.15)},
           "q_gc": {"data": (0.8, 1.0), "model": (1.7, 2.3)}}


@pytest.mark.parametrize("name", sorted(LM_BAND))
def test_lm_link_bytes_by_axis_within_bands(ref, name):
    got = _axis_bytes(_port(name).traffic)
    want = _axis_bytes(_ref_traffic(ref, name))
    ratio = {"data": got["data"] / want["data"],
             "model": got["model"] / (want["model"] + want["both"])}
    for ax, (lo, hi) in LM_BAND[name].items():
        assert lo <= ratio[ax] <= hi, (name, ax, ratio[ax])
    assert got["both"] == 0


# The float32 families, port over reference (its float32 bytes doubled
# back), in total over every pair: node and row arrays shard over (data,
# model) together, so XLA's product rings and DTensor's nested ones put the
# same bytes on different pair classes, and only the total compares. Op by
# op:
#   gin 3.0, eq 3.4, pna 4.0, mgn 1.6: per layer XLA gathers the node
#     features whole once and walks every arc on every device (its scan is
#     replicated), then all-reduces their gradient once; the port keeps the
#     arcs sharded, so each aggregation is a partial sum it reduce-scatters
#     to the rows, and the backward gathers that gradient back before
#     reduce-scattering the features' (two more row-array collectives a
#     layer); PNA does it for four aggregators (max and min as partial
#     maxima), MeshGraphNet for one of 3h-wide edge messages, where XLA's
#     edge MLP gathers more of its own.
#   tt_train 0.48, tt_score 0.65, tt_retrieve 0.87: both look the bags
#     and items up vocab-parallel (ids gathered to every device, each
#     device's rows of its table shard, partial over the row shards), but
#     XLA all-reduces the looked-up rows [B, H + 2, 256] over all 8 devices
#     before the bag's sum (3.4 MB at B = 64), where the port sums each bag
#     on the device that holds its rows and reduces the [B, 256] bags and
#     items onto the batch shards; the towers' weights and the [B, B]
#     logits move alike in both.
TOTAL_BAND = {"gin": (2.0, 4.5), "pna": (3.0, 6.0), "mgn": (1.2, 2.6),
              "eq": (2.4, 5.0), "tt_train": (0.35, 0.65),
              "tt_score": (0.5, 0.8), "tt_retrieve": (0.6, 1.1)}


@pytest.mark.parametrize("name", sorted(TOTAL_BAND))
def test_float32_families_link_bytes_within_bands(ref, name):
    got = _port(name).traffic.sum()
    want = _ref_traffic(ref, name).sum()
    lo, hi = TOTAL_BAND[name]
    assert lo <= got / want <= hi, (name, got / want)


def test_expert_profile_equals_2d_on_a_two_axis_mesh(ref):
    """Without a pod axis ``expert`` shards the experts over model, as 2d
    does: the same records in both packages."""
    a, b = _port("ds_2d"), _port("ds_expert")
    np.testing.assert_array_equal(a.traffic, b.traffic)
    assert a.link == b.link
    np.testing.assert_array_equal(ref["ds_2d"]["traffic"],
                                  ref["ds_expert"]["traffic"])


# ---------------------------------------------------------------------------
# The expert-parallel body
# ---------------------------------------------------------------------------

def _groups_axis(groups):
    g = np.asarray(groups)
    if g.shape[1] == 2 and (g[:, 1] - g[:, 0] == 4).all():
        return "data"
    if g.shape[1] == 4 and (np.diff(g, axis=1) == 1).all():
        return "model"
    return "other"


def test_expert_parallel_body_gathers_and_reduces_as_the_reference(ref):
    """``ep_shard_map=1`` (no remat, so each collective runs once): the
    body's three weight all-gathers over data and their three
    reduce-scatters in the backward, equal in count and elements to the
    reference's (its float32 upcast of the bf16 weights is twice the
    bytes), and the all-reduce of y over model at the reference's [t_l, D]
    size, once forward and once for its transpose."""
    e_l, d, f = 64 // 4, 2048, 1408
    w = e_l * d * f * 2                               # bf16 bytes
    got = _records("ds_ep")
    base = _records("ds_2d_noremat")

    def port(recs, op, nbytes, axis):
        return sum(r["op"] == op and r["bytes"] == nbytes
                   and r["axis"] == axis for r in recs)

    def refc(name, op, nbytes, axis):
        return sum(c[0] == op and c[1] == nbytes and c[2] is not None
                   and _groups_axis(c[2]) == axis
                   for c in ref[name]["collectives"])
    assert port(got, "all-gather", w, "data") == 3 == \
        refc("ds_ep", "all-gather", 2 * w, "data")
    assert port(got, "reduce-scatter", w // 2, "data") == 3 == \
        refc("ds_ep", "reduce-scatter", w, "data")
    assert port(base, "all-gather", w, "data") == 0 == \
        refc("ds_2d_noremat", "all-gather", 2 * w, "data")
    t_l = DS["batch"] * DS["seq"] // 2
    y = t_l * d * 2
    assert port(got, "all-reduce", y, "model") \
        - port(base, "all-reduce", y, "model") == 2
    # XLA's combiner merges the transpose into a tuple all-reduce; its
    # forward psum shows as one more [t_l, D] all-reduce over model
    assert refc("ds_ep", "all-reduce", 2 * y, "model") \
        - refc("ds_2d_noremat", "all-reduce", 2 * y, "model") == 1


def test_expert_parallel_route_equals_the_default_on_one_device():
    """On a (1, 1) mesh of a real one-process gloo world the expert-parallel
    body (its collectives the identity) and the default route give the
    plain ``moe_ffn``'s output and stats bitwise: the body is the same local
    dispatch. The gradients agree to float32 rounding (rel 1e-6): x's
    three uses (router, dispatch, shared experts) are summed in another
    order through the body's boundary."""
    import dataclasses
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.models import transformer as tr
    cfg = dataclasses.replace(configs.get("deepseek-v2-lite-16b")
                              .smoke_config(), capacity_factor=1.0)
    gen = torch.Generator().manual_seed(0)
    p = tr.init(cfg, gen, device="cpu")["layers"][1]["ffn"]
    x = torch.randn(24, cfg.d_model, generator=gen)

    def run(fn, xs, ps):
        ps = {k: v.detach().requires_grad_(True) for k, v in ps.items()}
        xs = xs.detach().requires_grad_(True)
        y, st = fn(ps, xs)
        y_l = y.to_local() if isinstance(y, DTensor) else y
        (y_l.sum() + (st.aux_loss.to_local()
                      if isinstance(st.aux_loss, DTensor)
                      else st.aux_loss)).backward()

        def local(t):
            return t.to_local() if isinstance(t, DTensor) else t
        return ([local(y).detach()] + [local(t).detach() for t in st]
                + [local(xs.grad)]
                + [local(ps[k].grad) for k in sorted(ps)])

    want = run(lambda ps, xs: tr.moe_ffn(ps, xs, cfg), x, p)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_mapped_mesh((1, 1), ("data", "model"))
        rules = sh.lm_rules(("data", "model"))
        specs = tr.param_specs(cfg, rules)["layers"][1]["ffn"]

        def dt(t, spec):
            return DTensor.from_local(t, mesh, sh.placements(mesh, spec),
                                      run_check=False)
        for ep in (True, False):
            c = dataclasses.replace(cfg, ep_shard_map=ep)
            got = run(lambda ps, xs: tr.moe_ffn(
                {k: dt(v, specs[k]) for k, v in ps.items()},
                dt(xs, rules.spec("batch", None)), c, rules), x, p)
            for a, b in zip(got[:3], want[:3]):
                assert torch.equal(a.reshape(b.shape), b)
            for a, b in zip(got[3:], want[3:]):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# grad_compress
# ---------------------------------------------------------------------------

def test_grad_compress_gathers_each_leaf_as_the_reference(ref):
    """The collectives compression adds: in both packages an all-gather of
    each sharded float32 leaf (gradient plus residual) over the mesh axes
    that shard any but its first dim of more than one element (the
    embedding over data, the unembedding and the layer's projections over
    model or data), equal in count and bytes; XLA's scalar all-reduce of the
    scales is one f32, the port's one a mesh axis per sharded leaf, 4
    bytes each."""
    def port_gathers(recs):
        return collections.Counter((r["bytes"], r["axis"]) for r in recs
                                   if r["op"] == "all-gather"
                                   and r["dtype"] == "float32")

    def ref_gathers(name):
        return collections.Counter(
            (c[1], _groups_axis(c[2])) for c in ref[name]["collectives"]
            if c[0] == "all-gather" and c[2] is not None)
    got = port_gathers(_records("q_gc")) - port_gathers(_records("q"))
    want = ref_gathers("q_gc") - ref_gathers("q")
    assert got == want and len(got) == 7
    extra = collections.Counter(
        (r["op"], r["bytes"]) for r in _records("q_gc")) - \
        collections.Counter((r["op"], r["bytes"]) for r in _records("q"))
    assert {op for op, b in extra if op != "all-gather"} <= {"all-reduce"}
    assert all(b == 4 for op, b in extra if op == "all-reduce")


def test_compress_quantizes_each_reference_stack():
    """``compress.roundtrip`` on DeepSeek's SMOKE gradients (1 dense + 1 MoE
    layer) equals the reference's on its ``dense_layers`` and
    ``moe_layers`` stacks, one scale a stacked leaf: each run of layers of
    one structure is one stack."""
    from repro.dist import compress as rcompress
    from repro.models import transformer as rtr
    from repro_torch import interop
    from repro_torch.dist import compress
    rcfg = rconfigs.get("deepseek-v2-lite-16b").smoke_config()
    rp, _ = rtr.init(jax.random.PRNGKey(1), rcfg, rsh.lm_rules(()))
    rp = jax.tree.map(lambda a: a * 3.0, rp)
    tp = interop.transformer_params_from(rp)
    want, wres = rcompress.roundtrip(rp)
    got, gres = compress.roundtrip(tp)
    for a, b in zip(tree.leaves(got),
                    tree.leaves(interop.transformer_params_from(want))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(tree.leaves(gres),
                    tree.leaves(interop.transformer_params_from(wres))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# Spec trees
# ---------------------------------------------------------------------------

def _unstack(spec):
    """The reference's spec tree with its stacked ``layers`` turned into
    one spec per layer (the stacked ``P(None, *s)`` is a layer's ``P(*s)``)."""
    per = jax.tree.map(lambda s: P(*tuple(s)[1:]), spec["layers"],
                       is_leaf=lambda s: isinstance(s, P))
    return per


def _flat(t, prefix=()):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _flat(t[k], prefix + (k,))
    elif isinstance(t, list):
        for i, v in enumerate(t):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tuple(t)


@pytest.mark.parametrize("arch", ["gin-tu", "pna", "meshgraphnet",
                                  "equiformer-v2", "two-tower-retrieval"])
@pytest.mark.parametrize("axes", [("pod", "data", "model"),
                                  ("data", "model")])
def test_spec_trees_equal_the_reference_init(arch, axes):
    """``param_specs`` against the spec tree of the reference's ``init``,
    leaf for leaf, one entry per dim of the port's params."""
    from repro.models import equiformer as req
    from repro.models import gnn as rgnn
    from repro.models import recsys as rrs
    from repro_torch.models import equiformer, gnn, recsys
    a, ra = configs.get(arch), rconfigs.get(arch)
    shape = next(iter(a.shapes))
    cfg, rcfg = a.make_config(shape), ra.make_config(shape)
    rmod, mod, rules, rrules = {
        "equiformer-v2": (req, equiformer, sh.gnn_rules(axes),
                          rsh.gnn_rules(axes)),
        "two-tower-retrieval": (rrs, recsys, sh.recsys_rules(axes),
                                rsh.recsys_rules(axes))}.get(
        arch, (rgnn, gnn, sh.gnn_rules(axes), rsh.gnn_rules(axes)))
    _, want = eval_shape_with_specs(lambda k: rmod.init(k, rcfg, rrules),
                                    jax.random.PRNGKey(0))
    got = mod.param_specs(cfg, rules)
    if "layers" in want:
        per = _unstack(want)
        assert len(got["layers"]) == cfg.n_layers
        for layer in got["layers"]:
            assert dict(_flat(layer)) == dict(_flat(per))
        want = {k: v for k, v in want.items() if k != "layers"}
        got = {k: v for k, v in got.items() if k != "layers"}
    assert dict(_flat(got)) == dict(_flat(want))
    params = (mod.init(cfg, None, device="meta"))
    full = mod.param_specs(cfg, rules)
    for x, spec in sh.spec_leaves(params, full):
        assert len(spec) == x.dim()


# ---------------------------------------------------------------------------
# EquiformerV2's chunked arcs
# ---------------------------------------------------------------------------

def test_equiformer_chunked_trace_scales_with_its_chunks():
    """The chunked path (ogb_products' ``edge_chunk``) traces its arc
    blocks unrolled and replicated, as GSPMD partitions the reference's
    scan: the node set, positions, arcs and the weights the blocks read are
    gathered once before the loop, so no collective lies inside a chunk.
    One chunk's collectives (none) scaled by the chunk count plus the rest
    equal the unrolled trace: the records at 2, 3 and 6 chunks are one, and
    ``scan_lengths`` carries the trip count as the reference's does."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import equiformer

    class Collectives(TorchDispatchMode):
        """Counts the functional collectives dispatched inside it."""
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace in ("_c10d_functional", "_dtensor"):
                self.n += 1
            return func(*args, **(kwargs or {}))

    base = {"n_layers": 1, "n": 1024, "arcs": 1536, "channels": 16,
            "l_max": 2}
    inner = equiformer._chunked_agg
    seen = []

    def chunked(lp, *args):
        assert not any(isinstance(t, DTensor)
                       for t in tree.leaves(lp) + list(args[:-1]))
        with Collectives() as mode:
            out = inner(lp, *args)
        seen.append(mode.n)
        return out
    recs = {}
    s = pl.PlacementSession(cache_dir="", device="cpu")
    equiformer._chunked_agg = chunked
    try:
        for chunk in (768, 512, 256):
            recs[chunk] = s.measure(
                "equiformer-v2", "ogb_products", mesh_shape=(2, 4),
                axes=("data", "model"),
                overrides=dict(base, edge_chunk=chunk))
    finally:
        equiformer._chunked_agg = inner
    assert seen == [0, 0, 0]
    for chunk in (512, 256):
        np.testing.assert_array_equal(recs[chunk].traffic, recs[768].traffic)
        assert recs[chunk].link == recs[768].link
        assert recs[chunk].by_op == recs[768].by_op
    assert [recs[c].scan_lengths for c in (768, 512, 256)] == \
        [[1, 2], [1, 3], [1, 6]]
