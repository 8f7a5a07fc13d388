"""The port's placement session (``repro_torch.launch.placement``) against
the reference's (``repro.launch.placement``): the stub-session cases of
``tests/test_placement.py`` through both packages on the same synthetic
traffic (reports equal: ``device_order``, ``rounds`` and ``axis_perm``
exactly, makespans within rel 1e-6), the report round trip, the trace
cache, ``map_step``, the CLIs' flags, and a real traced cell (qwen2-1.5b
at the reference's ``TINY_OVERRIDES`` on a (2, 4) fake mesh) against the
reference's record of the same cell, compiled by XLA on 8 host devices in
a subprocess."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import mapping as rmapping
from repro.core import topology as rtopology
from repro.launch import mesh as rmesh
from repro.launch import placement as rpl
from repro_torch.core import mapping, topology
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import placement as pl

TINY_OVERRIDES = {"n_layers": 1, "batch": 2, "seq": 8}
REL = 1e-6


def _record(mod, traffic, mesh_shape, link_bf16=None, order=None):
    d = int(np.prod(mesh_shape))
    base = dict(arch="synthetic", shape="cell", mesh_shape=tuple(mesh_shape),
                axes=("pod", "data")[:len(mesh_shape)], profile="2d",
                device_order=None if order is None else list(order),
                compile_s=0.0, calibrate_s=0.0, scan_lengths=[1],
                link=dict(link_bf16 or {}), operand={},
                link_bf16=dict(link_bf16 or {}), n_collectives=1,
                agg_flops=1.0, agg_bytes=1.0, memory={}, hlo_cal={},
                bytes_deep=0.0, traffic=np.asarray(traffic, np.float64))
    assert base["traffic"].shape == (d, d)
    return mod.CellRecord(**base)


def _stub(mod):
    class Stub(mod.PlacementSession):
        """Measures are synthetic traffic matrices; counts measures per
        device order as the real cache would."""

        def __init__(self, traffic_of_order, **kw):
            kw.setdefault("cache_dir", "")
            kw.setdefault("map_restarts", 8)
            if mod is pl:
                kw.setdefault("device", "cpu")
            super().__init__(**kw)
            self._traffic_of_order = traffic_of_order
            self.measured_orders = []

        def measure(self, arch_name, shape_name, *, mesh_shape=None,
                    axes=None, multi_pod=False, profile="2d",
                    grad_compress=False, overrides=None, device_order=None,
                    machine=None):
            if mesh_shape is None:
                mesh_shape, axes = self._resolve_machine(
                    machine, mesh_shape, axes, multi_pod)[1:]
            self.measured_orders.append(
                None if device_order is None else list(device_order))
            self.n_compiles += 1
            return _record(mod, self._traffic_of_order(device_order),
                           mesh_shape, link_bf16={"all-reduce": 64.0},
                           order=device_order)
    return Stub


def _heavy_axis_traffic(shape=(8, 2), hot=1e3):
    return mapping.collective_traffic_matrix(shape, {0: hot, 1: 1.0})


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=REL, abs=1e-9)
    else:
        assert a == b


def _reports_equal(got, want):
    assert got.device_order == want.device_order
    assert got.axis_perm == want.axis_perm
    assert got.axis_orders == want.axis_orders
    assert [{k: v for k, v in r.items() if k != "makespan"}
            for r in got.rounds] == \
        [{k: v for k, v in r.items() if k != "makespan"}
         for r in want.rounds]
    _close([r["makespan"] for r in got.rounds],
           [r["makespan"] for r in want.rounds])
    assert got.makespan_ratio == pytest.approx(want.makespan_ratio, rel=REL)
    _close(got.identity, want.identity)
    _close(got.searched, want.searched)
    _close(got.schedule_diff, want.schedule_diff)
    assert (got.n_compiles, got.cache_hits, got.n_candidates) == \
        (want.n_compiles, want.cache_hits, want.n_candidates)


# ---------------------------------------------------------------------------
# Schedule diff
# ---------------------------------------------------------------------------

def test_identity_to_identity_recompile_diffs_to_zero():
    T = _heavy_axis_traffic()
    ident = np.arange(16)
    for mod, topo_mod in ((pl, topology), (rpl, rtopology)):
        topo = topo_mod.balanced_tree((2, 8), level_cost=(8.0, 1.0))
        rec = _record(mod, T, (8, 2),
                      link_bf16={"all-gather": 3.0, "all-reduce": 7.0})
        kw = {"device": "cpu"} if mod is pl else {}
        d = mod.schedule_diff(rec, rec, topo, ident, ident, **kw)
        assert d["max_abs_delta"] == 0.0 and d["fixed_point"] is True
        for key in ("makespan", "bottleneck_link_bytes", "dcn_bytes",
                    "n_collectives"):
            assert d[key]["delta"] == 0.0


def test_schedule_diff_searched_side_equals_the_reference():
    T = _heavy_axis_traffic()
    topo = topology.balanced_tree((2, 8), level_cost=(8.0, 1.0))
    rtopo = rtopology.balanced_tree((2, 8), level_cost=(8.0, 1.0))
    best = rmapping.search((8, 2), rtopo, T)
    got = pl.schedule_diff(
        _record(pl, T, (8, 2), link_bf16={"all-reduce": 5.0}),
        _record(pl, T, (8, 2), link_bf16={"all-reduce": 5.0}), topo,
        np.arange(16), best.device_to_bin, device="cpu")
    want = rpl.schedule_diff(
        _record(rpl, T, (8, 2), link_bf16={"all-reduce": 5.0}),
        _record(rpl, T, (8, 2), link_bf16={"all-reduce": 5.0}), rtopo,
        np.arange(16), best.device_to_bin)
    _close(got, want)
    assert got["makespan"]["delta"] < 0


# ---------------------------------------------------------------------------
# The fixed-point loop (stubbed measures)
# ---------------------------------------------------------------------------

def test_place_never_worse_and_reaches_fixed_point_as_the_reference():
    T = _heavy_axis_traffic()
    (s, got), (rs, want) = [
        (st, st.place("synthetic", "cell", mesh_shape=(8, 2),
                      axes=("data", "model"), recompile=True))
        for st in (_stub(pl)(lambda order: T), _stub(rpl)(lambda order: T))]
    _reports_equal(got.report, want.report)
    rep = got.report
    assert rep.searched["makespan"] < rep.identity["makespan"]
    assert rep.schedule_diff["fixed_point"] is True
    assert [r["recompiled"] for r in rep.rounds] == [False, True]
    assert s.measured_orders == rs.measured_orders == [None,
                                                       rep.device_order]


def test_place_monotone_guard_as_the_reference():
    """The adversarial drift: each retrace a random permutation of the
    traffic from one seeded stream per package; the reports agree and
    searched never loses to identity."""
    T0 = _heavy_axis_traffic()

    def drift():
        rng = np.random.default_rng(3)

        def traffic_of(order):
            if order is None:
                return T0
            p = rng.permutation(16)
            return T0[np.ix_(p, p)]
        return traffic_of
    got = _stub(pl)(drift(), max_rounds=3).place(
        "synthetic", "cell", mesh_shape=(8, 2), axes=("data", "model"),
        recompile=True).report
    want = _stub(rpl)(drift(), max_rounds=3).place(
        "synthetic", "cell", mesh_shape=(8, 2), axes=("data", "model"),
        recompile=True).report
    _reports_equal(got, want)
    assert got.searched["makespan"] <= got.identity["makespan"] + 1e-9


def test_place_recompile_requires_a_round_budget():
    for mod in (pl, rpl):
        s = _stub(mod)(lambda order: _heavy_axis_traffic(), max_rounds=0)
        with pytest.raises(ValueError):
            s.place("synthetic", "cell", mesh_shape=(8, 2),
                    axes=("data", "model"), recompile=True)


def test_place_without_recompile_as_the_reference():
    reps = []
    for mod in (pl, rpl):
        s = _stub(mod)(lambda order: _heavy_axis_traffic())
        res = s.place("synthetic", "cell", mesh_shape=(8, 2),
                      axes=("data", "model"))
        assert res.report.schedule_diff is None
        assert res.searched_record is None and s.measured_orders == [None]
        reps.append(res.report)
    _reports_equal(*reps)


@pytest.mark.parametrize("machine", ["tpu-mixed-32", "torus-2d"])
def test_place_on_a_machine_as_the_reference(machine):
    """A machine preset supplies the mesh and the scored topology (a
    heterogeneous tree; a routing torus)."""
    reps = []
    for mod in (pl, rpl):
        shape = mod.machine_lib.resolve(machine).mesh_shape
        T = mapping.collective_traffic_matrix(
            shape, {i: 10.0 ** (len(shape) - i) for i in range(len(shape))})
        reps.append(_stub(mod)(lambda order: T).place(
            "synthetic", "cell", machine=machine, recompile=True).report)
    _reports_equal(*reps)


def test_report_to_json_roundtrips():
    rep = _stub(pl)(lambda order: _heavy_axis_traffic()).place(
        "synthetic", "cell", mesh_shape=(8, 2), axes=("data", "model"),
        recompile=True).report
    clone = pl.PlacementReport.from_json(rep.to_json())
    assert clone == rep
    assert "makespan" in rep.summary()
    assert "searched-vs-identity" in rep.diff_summary()


def test_search_warm_start_is_monotone_and_validated():
    topo = topology.mesh_tree((2, 8))
    rng = np.random.default_rng(0)
    T = np.triu(rng.uniform(0, 1, (16, 16)), 1)
    T = T + T.T
    ws = rng.permutation(16)
    got = mapping.search((2, 8), topo, T, warm_starts=[ws], device="cpu")
    assert got.bottleneck <= mapping.makespan_of_device_map(
        T, topo, ws, device="cpu") + 1e-9
    base = mapping.search((2, 8), topo, T, device="cpu")
    assert got.n_candidates == base.n_candidates + 1
    with pytest.raises(ValueError):
        mapping.search((2, 8), topo, T, warm_starts=[np.zeros(16, int)],
                       device="cpu")


# ---------------------------------------------------------------------------
# Real traces: the cache, map_step, the CLIs
# ---------------------------------------------------------------------------

def _tiny(session, **kw):
    return session.measure("qwen2-1.5b", "train_4k", mesh_shape=(2, 4),
                           axes=("data", "model"),
                           overrides=kw.pop("overrides", TINY_OVERRIDES),
                           **kw)


def test_trace_cache_hits_on_repeated_keys(tmp_path):
    s = pl.PlacementSession(cache_dir=str(tmp_path), map_restarts=2,
                            device="cpu")
    rec = _tiny(s)
    assert (s.n_compiles, s.n_cache_hits) == (1, 0) and not rec.cached
    rec2 = _tiny(s)
    assert (s.n_compiles, s.n_cache_hits) == (1, 1) and rec2.cached
    np.testing.assert_array_equal(rec2.traffic, rec.traffic)
    assert rec2.link_bf16 == rec.link_bf16
    _tiny(s, overrides={**TINY_OVERRIDES, "seq": 16})
    assert s.n_compiles == 2
    s2 = pl.PlacementSession(cache_dir=str(tmp_path), map_restarts=2,
                             device="cpu")
    rec3 = _tiny(s2)
    assert (s2.n_compiles, s2.n_cache_hits) == (0, 1) and rec3.cached
    assert rec3.scan_lengths == rec.scan_lengths == [1]
    assert rec3.by_op == rec.by_op and rec3.link_by_axis == rec.link_by_axis


def test_session_counts_in_report(tmp_path):
    s = pl.PlacementSession(cache_dir=str(tmp_path), map_restarts=2,
                            device="cpu")
    kw = dict(mesh_shape=(2, 4), axes=("data", "model"),
              overrides=TINY_OVERRIDES)
    rep1 = s.place("qwen2-1.5b", "train_4k", **kw).report
    assert (rep1.n_compiles, rep1.cache_hits) == (1, 0)
    rep2 = s.place("qwen2-1.5b", "train_4k", **kw).report
    assert (rep2.n_compiles, rep2.cache_hits) == (0, 1)


def test_verify_lints_traffic_and_refuses_the_kernel_verifier():
    # the kernel verifier is no longer refused: verify() runs it by default
    # (the reference's kernels=True), every kernel's plans clean
    s = pl.PlacementSession(cache_dir="", map_restarts=2, device="cpu")
    _tiny(s)
    assert s.verify(kernels=False) == []
    s._mem["bad"] = _record(pl, np.triu(np.ones((8, 8)), 1), (2, 4))
    assert any(f.check == "traffic-asymmetric" for f in s.verify())
    kernels = s.verify(kernels=True, traffic=False)
    assert kernels and all(f.subject.startswith("kernels/")
                           and f.severity == "info" for f in kernels)


@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k"])
def test_prefill_and_decode_cells_trace(kind):
    s = pl.PlacementSession(cache_dir="", device="cpu")
    rec = s.measure("qwen2-1.5b", kind, mesh_shape=(2, 4),
                    axes=("data", "model"),
                    overrides={"n_layers": 1, "batch": 2, "seq": 16})
    assert rec.n_collectives > 0 and rec.traffic.shape == (8, 8)
    assert s.verify(kernels=False) == []
    assert [f for f in s.verify() if f.severity != "info"] == []


def test_map_step_returns_a_mapped_mesh_and_report():
    from torch.distributed.tensor import DTensor, Shard
    s = pl.PlacementSession(cache_dir="", map_restarts=2, device="cpu")
    with mesh_lib.fake_world(8):
        mesh = s.local_mesh()
        x = DTensor.from_local(torch.empty(2, 4, device="meta"), mesh,
                               [Shard(0)], run_check=False)
        mapped, rep = s.map_step(lambda t: t.sum(), (x,), mesh, [1],
                                 tag="toy")
        assert tuple(mapped.shape) == (8,)
    assert rep.arch == "toy" and sorted(rep.device_order) == list(range(8))
    assert rep.searched["makespan"] <= rep.identity["makespan"] + 1e-9
    assert s.n_compiles == 1


def test_serving_mesh_spec_equals_the_reference():
    for n in (512, 256, 5):
        assert mesh_lib.serving_mesh_spec(n) == rmesh.serving_mesh_spec(n)
    assert mesh_lib.production_machine(True).name == \
        rmesh.production_machine(True).name


def test_train_cli_flags():
    from repro_torch.launch import train as tlaunch
    args = tlaunch._parser().parse_args(
        ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--steps",
         "1", "--profile", "sp", "--topology-aware"])
    setup = tlaunch.build(args)
    assert setup.rules.table["seq"] == ()           # one 'data' axis
    with pytest.raises(SystemExit):                 # no multi-device trainer
        tlaunch._parser().parse_args(["--arch", "qwen2-1.5b",
                                      "--map-restarts", "4"])
    with pytest.raises(ValueError, match=r"needs 512 devices, got 1"):
        tlaunch.build(tlaunch._parser().parse_args(
            ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
             "--machine", "tpu_v5e-512"]))
    # --lint runs the kernel verifier and the sharding lint, then builds
    linted = tlaunch.build(tlaunch._parser().parse_args(
        ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--lint"]))
    assert linted.arch.name == "qwen2-1.5b" and linted.params
    with pytest.raises(ValueError, match="profile"):
        tlaunch.build(tlaunch._parser().parse_args(
            ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
             "--profile", "3d"]))


def test_serve_cli_flags():
    from repro_torch.launch import serve as tserve
    args = tserve._parser().parse_args(
        ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--oneshot",
         "--profile", "fsdp", "--topology-aware", "--map-restarts", "4"])
    cfg, dev, params = tserve._setup(args)
    assert args.rules.table["fsdp"] == ("data",)
    a, _, _ = tserve.oneshot(params, cfg, dev, 2, 3, 4, 0.0, 0, args.rules)
    b, _, _ = tserve.oneshot(params, cfg, dev, 2, 3, 4, 0.0, 0)
    assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# A real trace against the reference's record of the same cell
# ---------------------------------------------------------------------------

REFERENCE_RECORD = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
from repro.launch.placement import PlacementSession
s = PlacementSession(cache_dir="", map_restarts=2)
out = {}
for prof in sys.argv[1:]:
    rec = s.measure("qwen2-1.5b", "train_4k", mesh_shape=(2, 4),
                    axes=("data", "model"), profile=prof,
                    overrides={"n_layers": 1, "batch": 2, "seq": 8})
    out[prof] = {"link_bf16": rec.link_bf16, "traffic": rec.traffic.tolist()}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_records():
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", REFERENCE_RECORD, "2d",
                          "fsdp", "sp"], env=env, capture_output=True,
                         text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _axis_bytes(T, shape=(2, 4)):
    """Link bytes of the pairs that differ along one mesh axis only, by
    axis, and of the pairs that differ along both ("both": a product-group
    ring)."""
    coords = np.argwhere(np.ones(shape))
    out = {"data": 0.0, "model": 0.0, "both": 0.0}
    for i in range(len(coords)):
        for j in range(i + 1, len(coords)):
            if T[i, j]:
                d = coords[i] != coords[j]
                key = "both" if d.all() else ("data" if d[0] else "model")
                out[key] += float(T[i, j])
    return out


# per-axis link bytes, the port's over the reference's (the reference's
# bf16-equivalent traffic), 2d and sp profiles. Op by op, in link bytes a
# device:
#   data axis (both read 0.65): the gradient reductions, 0.92: the port
#   reduce-scatters each gradient once, bf16, to its parameter's shards
#   (128.7 MB; the embedding's and the unembedding's [37,984, 768] shards
#   58.3 MB each), where XLA all-reduces the embedding's gradient whole
#   ([37,984, 1,536], 116.7 MB) and the layers' (140.3 MB in all). The
#   weight gathers, 0.40: the port gathers each FSDP weight once (59.1
#   MB); XLA gathers the unembedding and the FFN weights again for the
#   backward (148.3 MB), and at these 16 tokens DTensor contracts the
#   unembedding against activations resharded onto its rows (all-to-alls
#   of a few KB) rather than gathering it. (59.1 + 128.7) / (148.3 +
#   140.3) = 0.65.
#   model axis (2d 1.23, sp 0.79): the tensor-parallel reductions of the
#   attention and FFN outputs and the loss's three vocab reductions, in
#   both. Under 2d the port gathers the heads it cannot split evenly where
#   XLA swaps them with all-to-alls inside pairs of the model axis; under
#   sp both gather the sequence before the projections, and XLA
#   all-reduces outputs the port reduce-scatters to the sequence shards.
AXIS_BAND = {"data": (0.6, 0.8), "model": (0.75, 1.35)}


def test_traced_cell_against_the_reference_record(reference_records):
    s = pl.PlacementSession(cache_dir="", map_restarts=2, device="cpu")
    rec = {p: _tiny(s, profile=p) for p in ("2d", "expert", "fsdp", "sp")}
    want = {p: np.asarray(r["traffic"]) for p, r in
            reference_records.items()}
    # the same device pairs exchange bytes
    np.testing.assert_array_equal(rec["2d"].traffic > 0, want["2d"] > 0)
    # sp: the port's pairs are XLA's. XLA has more: it splits the model
    # axis in two to reshard the embedding's sequence shards (all-gathers
    # of [2, 4, 1,536] and of the labels over {0, 2}, {1, 3}, ...) and
    # permutes the shifted labels across both axes; together 8.5e-5 of
    # its bytes
    got_sp, want_sp = rec["sp"].traffic > 0, want["sp"] > 0
    assert not (got_sp & ~want_sp).any()
    assert want["sp"][want_sp & ~got_sp].sum() < 1e-3 * want["sp"].sum()
    for prof in ("2d", "sp"):
        got_ax = _axis_bytes(rec[prof].traffic)
        want_ax = _axis_bytes(want[prof])
        for ax, (lo, hi) in AXIS_BAND.items():
            ratio = got_ax[ax] / want_ax[ax]
            assert lo <= ratio <= hi, (prof, ax, ratio)
    # fsdp's two-axis shards: XLA reduces over the (data, model) product
    # ring, DTensor over two nested rings, one an axis
    assert _axis_bytes(want["fsdp"])["both"] > 0
    assert _axis_bytes(rec["fsdp"].traffic)["both"] == 0
    # expert is 2d on a dense arch, exactly
    np.testing.assert_array_equal(rec["expert"].traffic, rec["2d"].traffic)
    assert rec["expert"].link == rec["2d"].link
    assert s.verify(kernels=False) == []


def test_traced_train_step_reduces_each_gradient_once_in_its_dtype():
    """Each gradient leaves backward partial over the data axis and is
    reduced once, in bf16, to its parameter's shards: every data-axis
    reduction larger than the loss's per-token rows is bf16, and no
    parameter's local gradient size is reduced more often than parameters
    of that size exist (the embedding's and the unembedding's shards:
    exactly twice)."""
    import collections

    from repro_torch import configs, tree
    from repro_torch.launch.steps import build_cell, rules_for
    arch = configs.get("qwen2-1.5b")
    with mesh_lib.fake_world(8):
        mesh = mesh_lib.make_mapped_mesh((2, 4), ("data", "model"), None)
        cell = build_cell(arch, arch.shapes["train_4k"],
                          rules_for("lm", ("data", "model"), "2d"),
                          overrides=TINY_OVERRIDES)
        args = tuple(pl.meta_dtensors(a, sp, mesh) for a, sp in
                     zip(cell["args"], cell["args_specs"]))
        rec, _, _ = pl.trace_step(cell["step"], args, mesh)
        sizes = collections.Counter(
            p.to_local().numel() * p.to_local().element_size()
            for p in tree.leaves(args[0]))
    red = [r for r in rec.records if r["axis"] == "data"
           and r["op"] in ("all-reduce", "reduce-scatter")]
    assert {r["dtype"] for r in red if r["bytes"] > 4096} == {"bfloat16"}
    got = collections.Counter(r["bytes"] for r in red)
    for size, n in sizes.items():
        assert got[size] <= n, (size, got[size], n)
    embed = max(sizes)
    assert got[embed] == sizes[embed] == 2


def test_identity_retrace_diffs_to_zero_and_expert_equals_2d():
    s = pl.PlacementSession(cache_dir="", map_restarts=4, device="cpu")
    res = {p: s.place("qwen2-1.5b", "train_4k", mesh_shape=(2, 4),
                      axes=("data", "model"), profile=p,
                      overrides=TINY_OVERRIDES, recompile=True)
           for p in ("2d", "expert")}
    fresh = _tiny(pl.PlacementSession(cache_dir="", device="cpu"))
    topo = topology.mesh_tree((2, 4))
    ident = np.arange(8)
    d = pl.schedule_diff(res["2d"].record, fresh, topo, ident, ident,
                         device="cpu")
    assert d["max_abs_delta"] == 0
    a, b = res["2d"].report, res["expert"].report
    for f in ("identity", "searched", "makespan_ratio", "axis_perm",
              "device_order", "rounds", "schedule_diff"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.searched["makespan"] <= a.identity["makespan"]
