"""The port's static analysis against the reference's: twin of
``tests/test_analysis.py``.

The launch-plan verifier (``repro_torch.analysis.kernels``): every
registered plan verifies clean, at the examples and at the smoke run's
full-width shapes under the H100 ``DeviceModel``; the registry covers every
module that launches a kernel; one planted fault per check id, each
flagged at error; and "the plan is the launch": each module's ``launch``
passes exactly its plan's grid, threads, shared memory and path to the C
entry point (``build.entry`` replaced by a recorder). The reference's
verifier cannot be run under this jax (its ``tests/test_analysis.py``
fails there), so the port's is held to the reference's checks and
mutation tests instead. The CLI's suites: kernels and its JSON round trip,
and the serving, faults and embed suites field for field against the
reference's on the same inputs, clean and with one planted fault each
applied to both packages. The hooks: ``PlacementSession.verify()`` and
``--lint`` on the train and dry-run CLIs. The elastic
``ckpt.restore_sharded`` and the loop's mesh on a one-rank gloo world.
"""
import dataclasses
import io
import json
import re
import types
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.analysis import __main__ as jcli
from repro_torch import analysis
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import kernels as ak
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.dist import sharding
from repro_torch.kernels import (KERNEL_REGISTRY, bag_combine, bsr_spmm,
                                 bucket_assign, build, flash_attention,
                                 gather_combine, match_keys, partition_gain)
from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels import quotient_link_loads as qll
from repro_torch.train import loop

torch.set_num_threads(1)
KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels"


def _gating(findings):
    return [f for f in findings if f.severity != "info"]


def _errors(findings, check):
    return [f for f in findings if f.check == check and f.severity == "error"]


# ---------------------------------------------------------------------------
# the registry and clean plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(KERNEL_REGISTRY))
def test_every_registered_plan_verifies_clean(name):
    plans = KERNEL_REGISTRY[name]()
    assert plans and all(p.name == name for p in plans)
    findings = ak.verify_kernel(name)
    assert _gating(findings) == [], analysis.format_findings(findings)
    assert any(f.check == "smem-budget" for f in findings)


def test_every_launch_variant_has_an_example():
    """The examples reach every launch variant the paths use."""
    kinds = {(p.entry, p.kernel.split("<")[0], p.args.get("path"),
              p.args.get("variant")) for f in KERNEL_REGISTRY.values()
             for p in f()}
    paths = {(e, v) for e, _, _, v in kinds}
    for want in [("bag_combine", "small64"), ("bag_combine", "deep"),
                 ("bag_combine", "flat"), ("gather_combine", "wide"),
                 ("gather_combine", "deep"), ("gather_combine", "small16")]:
        assert want in paths
    entries = {(e, k) for e, k, _, _ in kinds}
    assert {("match_round", "match_round_kernel"),
            ("prefix_split", "prefix_split_kernel"),
            ("flash_attention", "flash_fwd_wgmma_kernel"),
            ("flash_attention", "flash_fwd_kernel")} <= entries
    flash = {p.kernel for p in KERNEL_REGISTRY["flash_attention"]()}
    assert {"flash_fwd_wgmma_kernel<64,64>", "flash_fwd_wgmma_kernel<128,128>",
            "flash_fwd_wgmma_kernel<192,128>"} <= flash
    bsr = {p.args["tile"] for p in KERNEL_REGISTRY["bsr_spmm"]()}
    assert bsr == {bsr_spmm.WIDE_TILE, bsr_spmm.NARROW_TILE}
    split = {p.args["path"] for p in KERNEL_REGISTRY["bucket_assign"]()
             if p.entry == "prefix_split"}
    assert split == {"one_block", "cooperative"}
    w = {p.args["path"] for p in KERNEL_REGISTRY["quotient_link_loads"]()}
    assert w == {"smem_w", "global_w"}


# the smoke run's full-width launches (chip_smoke.py)
FULL_WIDTH = {
    "flash prefill 4 x 4096": lambda: flash_attention.plan(
        4, 4096, 4096, 12, 2, 128, 128, torch.bfloat16),
    "flash prefill 1 x 32768": lambda: flash_attention.plan(
        1, 32768, 32768, 12, 2, 128, 128, torch.bfloat16),
    "flash MLA train (192, 128)": lambda: flash_attention.plan(
        1, 4096, 4096, 16, 16, 192, 128, torch.bfloat16, lse=True),
    "flash float32 with lse": lambda: flash_attention.plan(
        2, 1024, 1024, 8, 8, 64, 64, torch.float32, lse=True),
    "bsr bulk layout": lambda: bsr_spmm.plan(3840, 128, 64, 11_008, 3840,
                                             True),
    "gather serve_bulk": lambda: gather_combine.plan(
        262_144, 50, 1_000_000, 256, torch.float32, 4, True),
    "gather serve_p99 bf16": lambda: gather_combine.plan(
        512, 50, 1_000_000, 256, torch.bfloat16, 8, True),
    "bag serve_bulk": lambda: bag_combine.plan(262_144, 50, 256,
                                               torch.float32, 4),
    "bag train_recsys": lambda: bag_combine.plan(32_768, 50, 256,
                                                 torch.float32, 4),
    "qll k = 512": lambda: qll.plan(1_548_288, 262_144, 512, 584),
    "qll k = 64": lambda: qll.plan(1_548_288, 262_144, 64, 126),
    "match_round level 0": lambda: match_keys.round_plan(1_548_288,
                                                         262_144),
    "prefix_split 1M": lambda: bucket_assign.split_plan(1_000_000, 511),
    "partition_gain full cell": lambda: partition_gain.plan(262_144, 6, 8),
}


@pytest.mark.parametrize("case", sorted(FULL_WIDTH))
def test_full_width_plans_verify_clean(case):
    p = FULL_WIDTH[case]()
    findings = ak.verify_plan(p, device=plan_lib.H100)
    assert _gating(findings) == [], analysis.format_findings(findings)


def test_registry_covers_every_launching_module():
    """Every ``kernels/*.py`` with a ``build.entry(`` launch is registered
    (``l2_read.cu`` has no module: the smoke run's probe)."""
    launching = {f.stem for f in KERNELS.glob("*.py")
                 if 'build.entry("' in f.read_text()}
    assert launching == set(KERNEL_REGISTRY)


def test_verify_all_is_fast_and_clean():
    import time
    t0 = time.perf_counter()
    findings = ak.verify_all()
    assert time.perf_counter() - t0 < 10.0
    assert _gating(findings) == []
    subjects = {f.subject for f in findings}
    assert subjects == {f"kernels/{n}" for n in KERNEL_REGISTRY}


# ---------------------------------------------------------------------------
# mutations: one planted fault per check id, each an error
# ---------------------------------------------------------------------------

def _pg():
    return KERNEL_REGISTRY["partition_gain"]()[0]


def _wgmma():
    return next(p for p in KERNEL_REGISTRY["flash_attention"]()
                if p.tma)


def test_mutation_racing_write_map_is_flagged():
    p = _pg()
    rows, k = p.args["rows"], p.outputs[0].shape[1]
    racing = dataclasses.replace(p, writes=(
        lambda b: [((0, rows), (0, k))],))
    assert _errors(ak.verify_plan(racing), "write-race")


def test_mutation_unwritten_output_block_is_flagged():
    p = _pg()
    short = dataclasses.replace(p, grid=(p.grid[0] - 1,))
    found = _errors(ak.verify_plan(short), "coverage")
    assert found and found[0].detail["element"][0] == (
        (p.grid[0] - 1) * p.args["rows"])


def test_mutation_overhanging_tile_is_flagged():
    p = partition_gain.plan(1001, 8, 8)
    assert p.outputs[0].shape[0] % p.args["rows"]
    assert _gating(ak.verify_plan(p)) == []
    unmasked = dataclasses.replace(p, masked_edges=((False, False),))
    assert _errors(ak.verify_plan(unmasked), "block-bounds")


def test_mutation_oversized_shared_memory_is_flagged():
    p = dataclasses.replace(_wgmma(), dyn_smem=230 * 1024)
    assert _errors(ak.verify_plan(p), "smem-budget")


def test_mutation_shared_memory_without_optin_is_flagged():
    p = dataclasses.replace(_pg(), dyn_smem=64 * 1024, smem_optin=False)
    assert _errors(ak.verify_plan(p), "smem-budget")
    assert _gating(ak.verify_plan(dataclasses.replace(p, smem_optin=True))
                   ) == []


def test_mutation_cooperative_grid_past_residency_is_flagged():
    per_sm = plan_lib.H100.resident_blocks(qll.THREADS, 0,
                                           qll.BLOCKS_PER_SM)
    past = qll._plan(1_548_288, 262_144, 512, 584, None,
                     blocks=per_sm * plan_lib.H100.sms + 1)
    assert _errors(ak.verify_plan(past), "co-residency")
    # the same grid is lawful where it is not cooperative
    assert not _errors(ak.verify_plan(
        dataclasses.replace(past, cooperative=False, phases=1,
                            writes=past.writes[:1] + (
                                lambda b: [((0, 584),)] if b == 0 else [],
                            ))), "co-residency")


def test_mutation_too_many_threads_is_flagged():
    p = dataclasses.replace(_pg(), threads=(1025,))
    assert _errors(ak.verify_plan(p), "block-threads")
    warn = ak.verify_plan(dataclasses.replace(_pg(), threads=(100,)))
    assert [f.severity for f in warn if f.check == "block-threads"] == [
        "warning"]


def test_mutation_misaligned_tma_stride_is_flagged():
    p = _wgmma()
    m = p.tma[0]
    bad = m._replace(strides=(8,) + m.strides[1:])
    found = _errors(ak.verify_plan(dataclasses.replace(
        p, tma=(bad,) + p.tma[1:])), "tma-descriptor")
    assert found and "16" in found[0].message
    wide = m._replace(box=(128,) + m.box[1:])   # 256 B past the 128 B swizzle
    assert _errors(ak.verify_plan(dataclasses.replace(
        p, tma=(wide,) + p.tma[1:])), "tma-descriptor")


@pytest.mark.parametrize("grid", [(2.5,), (0,), (), (1, 1, 1, 1),
                                  (2 ** 31,), (1, 65536)])
def test_mutation_bad_grid_is_flagged(grid):
    p = dataclasses.replace(_pg(), grid=grid)
    assert _errors(ak.verify_plan(p), "grid")


def test_mutation_phases_without_barrier_is_flagged():
    p = KERNEL_REGISTRY["quotient_link_loads"]()[1]
    assert p.cooperative and p.phases == 2
    assert _errors(ak.verify_plan(dataclasses.replace(p, cooperative=False)),
                   "write-race")
    # and the barrier is what makes block 0's zeroing lawful beside the
    # other blocks' W slices: the same writes in one phase race on W
    one = dataclasses.replace(p, writes=(
        lambda b: [((0, p.outputs[0].shape[0]),)],) + p.writes[1:])
    assert _errors(ak.verify_plan(one), "write-race")


def test_mutation_impure_and_misranked_maps_are_flagged():
    p = _pg()
    bad = dataclasses.replace(p, writes=(lambda b: [((0.5, 1), (0, 1))],))
    assert _errors(ak.verify_plan(bad), "index-purity")
    raises = dataclasses.replace(p, reads=(p.reads[0], lambda b: 1 / 0,
                                           p.reads[2]))
    assert _errors(ak.verify_plan(raises), "index-purity")
    rank = dataclasses.replace(p, writes=(lambda b: [((0, 1),)],))
    assert _errors(ak.verify_plan(rank), "block-rank")
    missing = dataclasses.replace(p, writes=())
    assert _errors(ak.verify_plan(missing), "block-rank")


def test_out_of_bounds_read_is_flagged():
    p = _pg()
    n, d = p.operands[1].shape
    oob = dataclasses.replace(p, reads=(p.reads[0], lambda b: [
        ((b * 8, b * 8 + 9), (0, d))], p.reads[2]))
    assert _errors(ak.verify_plan(oob), "block-bounds")


def test_misaligned_vector_access_warns():
    p = dataclasses.replace(_wgmma(), vectors=(("q", 100, 0),))
    found = [f for f in ak.verify_plan(p) if f.check == "tiling-alignment"]
    assert [f.severity for f in found] == ["warning"]


def test_large_grids_are_sampled_out_loud():
    p = bag_combine.plan(262_144, 50, 256, torch.float32, 4)
    findings = ak.verify_plan(p)
    assert [f.check for f in findings if f.check == "grid-sampled"] == [
        "grid-sampled"]
    assert _gating(findings) == []
    small = ak.verify_plan(p, max_grid_points=p.blocks)
    assert not [f for f in small if f.check == "grid-sampled"]
    assert _gating(small) == []


def test_broken_example_plans_is_a_registry_finding(monkeypatch):
    def boom():
        raise RuntimeError("no plan")
    monkeypatch.setitem(KERNEL_REGISTRY, "partition_gain", boom)
    found = ak.verify_kernel("partition_gain")
    assert [(f.check, f.severity) for f in found] == [("registry", "error")]
    assert _errors(ak.verify_kernel("no_such_kernel"), "registry")


# ---------------------------------------------------------------------------
# the plan is the launch
# ---------------------------------------------------------------------------

class _Recorder:
    def __init__(self):
        self.calls = []

    def entry(self, name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes), (name, args)
            self.calls.append((name, args))
            return 0
        return fn


def _fake(arg):
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "int32": torch.int32, "int64": torch.int64,
             "bool": torch.bool}[arg.dtype]
    return torch.empty(1, dtype=dtype).expand(*arg.shape)


def _launch(p, rec):
    """``p``'s module ``launch`` on stand-in tensors of its shapes."""
    ops = [_fake(a) for a in p.operands]
    outs = [_fake(a) for a in p.outputs]
    e = p.entry
    if e == "partition_gain":
        partition_gain.launch(p, *ops, *outs, stream=0)
    elif e == "quotient_link_loads":
        qll.launch(p, *ops[:6], *outs, ops[6], 0, stream=0)
    elif e == "match_keys":
        match_keys.launch(p, *ops, *outs, stream=0)
    elif e == "match_round":
        match_keys.launch_round(p, *ops[:5], *outs, ops[5], stream=0)
    elif e == "bucket_assign":
        bucket_assign.launch(p, *ops, *outs, ops[1].shape[0] + 1, stream=0)
    elif e == "prefix_split":
        bucket_assign.launch_split(p, *ops[:2], *outs, ops[2],
                                   ops[1].shape[0] + 1, stream=0)
    elif e == "bag_combine":
        bag_combine.launch(p, *ops, *outs, stream=0)
    elif e == "gather_combine":
        gather_combine.launch(p, *ops, *outs, stream=0)
    elif e == "bsr_spmm":
        bsr_spmm.launch(p, *ops, *outs, stream=0)
    elif e == "flash_attention":
        flash_attention.launch(p, *ops, outs[0],
                               outs[1] if len(outs) > 1 else None, True,
                               stream=0)
    else:
        raise AssertionError(e)
    (name, args), = rec.calls
    return name, args


# the statics after the data pointers and sizes each entry takes, by name
_PATH_ARGS = {
    "partition_gain": lambda p, a: a[-10:-8] == (p.args["rows"],
                                                 p.args["d_chunk"]),
    "quotient_link_loads": lambda p, a: True,
    "match_keys": lambda p, a: True,
    "match_round": lambda p, a: True,
    "bucket_assign": lambda p, a: True,
    "prefix_split": lambda p, a: a[-9] == int(p.cooperative),
    "bag_combine": lambda p, a: a[-11:-8] == (p.args["vec"], {
        "float32": 4, "bfloat16": 2}[p.outputs[0].dtype], p.args["code"]),
    "gather_combine": lambda p, a: a[-11:-8] == (p.args["vec"], {
        "float32": 4, "bfloat16": 2}[p.outputs[0].dtype], p.args["code"]),
    "bsr_spmm": lambda p, a: a[-10:-8] == (p.args["wide"], p.args["vec"]),
    "flash_attention": lambda p, a: a[-11:-8] == (p.args["code"],
                                                  p.args["dm"],
                                                  p.args["dvm"]),
}


@pytest.mark.parametrize("name", sorted(KERNEL_REGISTRY))
def test_the_plan_is_the_launch(monkeypatch, name):
    for p in KERNEL_REGISTRY[name]():
        rec = _Recorder()
        monkeypatch.setattr(build, "entry", rec.entry)
        got, args = _launch(p, rec)
        assert got == p.entry
        assert tuple(args[-8:-1]) == p.launch_dims(), p.kernel
        assert args[-1] == 0
        assert _PATH_ARGS[p.entry](p, tuple(args)), (p.kernel, args)


def test_launch_dims_pad_to_dim3():
    p = KERNEL_REGISTRY["bag_combine"]()[0]
    gx, gy, gz, bx, by, bz, smem = p.launch_dims()
    assert (gx, gy, gz) == (*p.grid, 1) and (bx, by, bz) == (*p.threads, 1)
    assert smem == p.dyn_smem == 0


def test_plans_are_cached_by_shape():
    a = partition_gain.plan(777, 5, 4)
    assert partition_gain.plan(777, 5, 4) is a
    assert a in plan_lib.cached_plans(["partition_gain"])
    assert partition_gain.plan(778, 5, 4) is not a


def test_wrapper_rules_are_the_plans():
    """The helpers the card tests and the smoke read give the plans'
    choices (the C launchers no longer decide)."""
    sms = plan_lib.H100.sms
    for b, f, path in [(262_144, 256, "wide_rows"), (512, 256, "rows"),
                       (1, 256, "small_grid")]:
        assert gather_combine.path(b, f, torch.float32, True, sms) == path
        p = gather_combine.plan(b, 50, 1000, f, torch.float32, 4, True)
        assert p.args["path"] == path
    assert (bucket_assign.split_plan(bucket_assign.SPLIT_TILE, 63).blocks,
            bucket_assign.split_plan(bucket_assign.SPLIT_TILE + 1,
                                     63).blocks) == (1, 2)
    for m, k in [(2_048, 4), (1_548_288, 512), (122_656, 64)]:
        p = qll.plan(m, 1000, k, 10)
        path = qll.qll_path(m, k, sms)
        assert (p.blocks, p.block_threads, p.dyn_smem) == tuple(path)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_kernels_suite_and_json_roundtrip(tmp_path):
    path = tmp_path / "findings.json"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["--suite", "kernels", "--json", str(path)])
    assert rc == 0
    out = buf.getvalue()
    assert "[ANALYSIS] gate clean at severity 'error'" in out
    assert f"[ANALYSIS] wrote" in out
    doc = json.loads(path.read_text())
    assert doc["gate"] == {"severity": "error", "failed": False}
    assert doc["counts"]["error"] == 0 and doc["counts"]["warning"] == 0
    assert len(doc["findings"]) == sum(doc["counts"].values())
    assert {f["subject"] for f in doc["findings"]} == {
        f"kernels/{n}" for n in KERNEL_REGISTRY}
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["--suite", "kernels", "--severity", "info",
                       "--quiet"])
    assert rc == 1 and "GATE FAILED" in buf.getvalue()


def test_cli_gate_fails_on_a_planted_kernel_fault(monkeypatch, tmp_path):
    p = _pg()
    monkeypatch.setitem(KERNEL_REGISTRY, "partition_gain", lambda: [
        dataclasses.replace(p, grid=(p.grid[0] - 1,))])
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["--suite", "kernels", "--quiet"])
    assert rc == 1
    assert re.search(r"\[ERROR  \] coverage +kernels/partition_gain",
                     buf.getvalue())


def test_cli_flags_and_defaults_match_the_reference():
    assert cli.DEFAULT_ARCHS == jcli.DEFAULT_ARCHS
    for argv in (["--help"],):
        with pytest.raises(SystemExit), redirect_stdout(io.StringIO()) as b:
            cli.main(argv)
        ours = b.getvalue()
        with pytest.raises(SystemExit), redirect_stdout(io.StringIO()) as b:
            jcli.main(argv)
        theirs = b.getvalue()
    flags = re.compile(r"--[a-z-]+")
    assert set(flags.findall(ours)) == set(flags.findall(theirs))


def _fields(findings):
    return [(f.check, f.severity, f.subject, f.message) for f in findings]


@pytest.mark.parametrize("suite", ["serving", "faults", "embed"])
def test_host_suites_equal_the_reference(suite):
    ours = getattr(cli, f"run_{suite}_suite")()
    theirs = getattr(jcli, f"run_{suite}_suite")()
    assert _fields(ours) == _fields(theirs)


def _asymmetric(self):
    t = np.zeros((3, 3))
    t[0, 1] = 2.0
    t[1, 0] = 1.0
    return t


def test_serving_suite_planted_asymmetric_traffic(monkeypatch):
    from repro import serving as jserving
    from repro_torch import serving
    monkeypatch.setattr(serving.PagedKVCache, "page_traffic", _asymmetric)
    monkeypatch.setattr(jserving.PagedKVCache, "page_traffic", _asymmetric)
    ours, theirs = cli.run_serving_suite(), jcli.run_serving_suite()
    assert any(f.severity == "error" for f in ours)
    assert _fields(ours) == _fields(theirs)


def test_faults_suite_planted_unchanged_cache_token(monkeypatch):
    from repro.core import machine as jmachine
    from repro_torch.core import machine
    monkeypatch.setattr(machine.MachineSpec, "cache_token",
                        lambda self: "same")
    monkeypatch.setattr(jmachine.MachineSpec, "cache_token",
                        lambda self: "same")
    ours, theirs = cli.run_faults_suite(), jcli.run_faults_suite()
    assert [f for f in ours if f.check == "fault-degrade"]
    assert _fields(ours) == _fields(theirs)


def test_embed_suite_planted_shard_sizes(monkeypatch):
    from repro.embed import sharded_table as jst
    from repro_torch.embed import sharded_table as st

    def off(self):
        sizes = np.diff(self.offsets).copy()
        sizes[0] += 1
        sizes[1] -= 1
        return sizes
    monkeypatch.setattr(st.ShardPlan, "shard_sizes", property(off))
    monkeypatch.setattr(jst.ShardPlan, "shard_sizes", property(off))
    ours, theirs = cli.run_embed_suite(), jcli.run_embed_suite()
    assert [f for f in ours if f.check == "embed-plan"]
    assert _fields(ours) == _fields(theirs)


# ---------------------------------------------------------------------------
# the hooks
# ---------------------------------------------------------------------------

def test_session_verify_covers_kernels_and_traffic():
    from repro_torch.launch.placement import PlacementSession
    s = PlacementSession(cache_dir="", device="cpu")
    findings = s.verify()
    assert {f.subject for f in findings} >= {
        f"kernels/{n}" for n in KERNEL_REGISTRY}
    assert not analysis.at_least(findings, "error")
    s._mem["planted"] = types.SimpleNamespace(
        traffic=_asymmetric(None), arch="qwen2-1.5b", shape="train_4k",
        profile="2d")
    planted = s.verify()
    assert [f for f in planted if f.subject == "qwen2-1.5b/train_4k/2d"
            and f.severity == "error"]
    assert not [f for f in s.verify(kernels=False)
                if f.subject.startswith("kernels/")]
    assert not [f for f in s.verify(traffic=False)
                if f.subject == "qwen2-1.5b/train_4k/2d"]


def test_train_cli_lint_runs_at_smoke():
    from repro_torch.launch import train
    buf = io.StringIO()
    with redirect_stdout(buf):
        train.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                    "--steps", "1", "--lint"])
    out = buf.getvalue()
    assert "kernels/flash_attention" in out
    assert "[ANALYSIS] 0 error(s)" in out and "steps=1" in out


def test_train_cli_lint_aborts_on_an_error(monkeypatch):
    from repro_torch.launch import train
    p = _pg()
    monkeypatch.setitem(KERNEL_REGISTRY, "partition_gain", lambda: [
        dataclasses.replace(p, threads=(2048,))])
    with pytest.raises(SystemExit, match="error-severity"), \
            redirect_stdout(io.StringIO()):
        train.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                    "--steps", "1", "--lint"])


def test_dryrun_lint_runs_the_kernel_verifier(tmp_path):
    from repro_torch.launch import dryrun
    buf = io.StringIO()
    with redirect_stdout(buf):
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k",
                     "--device", "cpu", "--override", "n_layers=1",
                     "--override", "batch=2", "--override", "seq=8",
                     "--cache-dir", "", "--out", str(tmp_path), "--lint"])
    out = buf.getvalue()
    assert "kernel-plan-pending" not in out
    assert "kernels/bsr_spmm" in out and "[ANALYSIS] 0 error(s)" in out


# ---------------------------------------------------------------------------
# restore_sharded and the loop's mesh, on a one-rank gloo world
# ---------------------------------------------------------------------------

@pytest.fixture
def gloo_world(tmp_path):
    assert not dist.is_initialized()
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_elastic_reshard(tmp_path, gloo_world):
    """Restore onto the *current* mesh regardless of the saving layout."""
    from torch.distributed.tensor import DTensor
    t = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4)}
    ckpt.save(str(tmp_path / "c"), 1, t)
    mesh = loop._default_mesh(4)
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("data",)
    spec = sharding.Spec("data", None)
    restored, step = ckpt.restore_sharded(str(tmp_path / "c"), t,
                                          {"w": spec}, mesh)
    assert step == 1 and isinstance(restored["w"], DTensor)
    assert restored["w"].device_mesh is mesh
    assert restored["w"].placements == sharding.placements(mesh, spec)
    assert torch.equal(restored["w"].full_tensor(), t["w"])


def _full(tree):
    from torch.distributed.tensor import DTensor
    return {k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in tree.items()}


def _toy_step(params, opt_state, batch):
    g = batch["x"].mean()
    params = {"w": params["w"] - 0.1 * g}
    return params, opt_state, {"loss": (params["w"].sum() ** 2)}


def _toy_factory(start):
    def gen():
        i = start
        while True:
            yield {"x": torch.full((4,), float(i + 1))}
            i += 1
    return gen()


def _params():
    return {"w": torch.linspace(0.5, 1.5, 3)}


def test_run_with_mesh_resumes_bitwise(tmp_path, gloo_world):
    from torch.distributed.tensor import DTensor
    cfg = loop.LoopConfig(total_steps=4, ckpt_every=2,
                          ckpt_dir=str(tmp_path / "c"))
    loop.run(_toy_step, _params(), None, _toy_factory(0), cfg)
    more = dataclasses.replace(cfg, total_steps=8)
    mesh = loop._default_mesh(1)
    p_mesh, _, r_mesh = loop.run(_toy_step, _params(), None,
                                 _toy_factory(4), more, mesh=mesh,
                                 state_specs=True)
    assert isinstance(p_mesh["w"], DTensor)
    # the plain restore from the same checkpoint
    plain_cfg = dataclasses.replace(more, ckpt_dir=str(tmp_path / "p"))
    loop.run(_toy_step, _params(), None, _toy_factory(0),
             dataclasses.replace(plain_cfg, total_steps=4))
    p_plain, _, r_plain = loop.run(_toy_step, _params(), None,
                                   _toy_factory(4), plain_cfg)
    assert r_mesh.resumed_from == r_plain.resumed_from == 4
    assert r_mesh.losses == r_plain.losses                    # bitwise
    assert torch.equal(_full(p_mesh)["w"], p_plain["w"])


def test_run_supervised_rebuilds_the_mesh(tmp_path, gloo_world):
    from repro_torch import resilience as tres
    _, _, clean = loop.run(_toy_step, _params(), None, _toy_factory(0),
                           loop.LoopConfig(total_steps=12, ckpt_every=4))
    cfg = loop.LoopConfig(total_steps=12, ckpt_every=4,
                          ckpt_dir=str(tmp_path / "c"))
    built = []

    def mesh_fn(n_alive):
        built.append(n_alive)
        return loop._default_mesh(n_alive)
    plan = tres.FaultPlan((tres.FaultEvent(7, "leaf_death", 1),))
    p, _, sup = loop.run_supervised(_toy_step, _params(), None,
                                    _toy_factory, cfg, plan,
                                    machine="tpu_v5e-256", mesh_fn=mesh_fn)
    assert built == [256, 255]
    assert sup.attempts == 2 and sup.recoveries[0]["resumed_from"] == 4
    assert sup.losses == clean.losses                          # bitwise
    assert loop._default_mesh(255).size() == 1                 # clamped
    # the default mesh_fn gives the same run
    _, _, dflt = loop.run_supervised(
        _toy_step, _params(), None, _toy_factory, dataclasses.replace(
            cfg, ckpt_dir=str(tmp_path / "d")), plan, machine="tpu_v5e-256")
    assert dflt.losses == clean.losses


def test_default_mesh_without_a_process_group_is_none():
    assert not dist.is_initialized()
    assert loop._default_mesh(4) is None
