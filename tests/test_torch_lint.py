"""The port's static checks against the reference's: the ``Finding``
helpers (the same strings and JSON on the same findings), ``lint_ops``
(the twin of ``lint_jaxpr``: bf16 -> float32 upcasts of a traced step),
``lint_cell`` (its spec findings those of ``lint_spec_tree`` and of the
reference's ``lint_cell``), the dry-run CLI on the CPU and its lint gate,
and ``scripts/torch_diag_cell.py``."""
import dataclasses
import io
import json
import os
import runpy
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from repro import analysis as ranalysis
from repro.analysis import shard_lint as rlint
from repro_torch import analysis
from repro_torch.analysis import shard_lint
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch import placement as pl

ROOT = Path(__file__).resolve().parent.parent
TINY_LM = ["--override", "n_layers=1", "--override", "batch=8",
           "--override", "seq=16"]

FINDINGS = [
    ("traffic-asymmetric", "error", "qwen2-1.5b/train_4k/2d",
     "asymmetric traffic", {"max_asym": 1.5}),
    ("bf16-upcast", "warning", "cell", "bf16 -> f32 upcast of [4096, 1024]",
     {"shape": [4096, 1024], "elements": 4194304, "sites": 2}),
    ("bf16-upcast", "info", "cell", "2 bf16 -> f32 upcast site(s)", {}),
    ("replicated-param", "warning", "cell:['embed']", "17 MiB tensor", {}),
]


@pytest.mark.parametrize("n", [0, 1, 2, 4])
def test_finding_helpers_equal_the_reference(n):
    ours = [analysis.Finding(*f) for f in FINDINGS[:n]]
    theirs = [ranalysis.Finding(*f) for f in FINDINGS[:n]]
    assert analysis.format_findings(ours) == \
        ranalysis.format_findings(theirs)
    for gate in ("error", "warning", "info"):
        assert analysis.to_json(ours, gate_severity=gate) == \
            ranalysis.to_json(theirs, gate_severity=gate)
        assert [dataclasses.asdict(f) for f in analysis.at_least(ours, gate)] \
            == [dataclasses.asdict(f) for f in ranalysis.at_least(theirs,
                                                                  gate)]
    assert analysis.counts(ours) == ranalysis.counts(theirs)
    assert analysis.max_severity(ours) == ranalysis.max_severity(theirs)
    assert [analysis.severity_rank(s) for s in analysis.SEVERITIES] == \
        [ranalysis.severity_rank(s) for s in ranalysis.SEVERITIES]
    for f, g in zip(ours, theirs):
        assert f.format() == g.format()


def _upcasts_of(fn, *args):
    rec = op_cost.OpCostRecorder()
    with rec:
        fn(*args)
    return rec


def test_lint_ops_flags_a_large_upcast_and_not_a_float32_step():
    """A planted ``.float()`` of a 2^22-element bf16 tensor warns (on meta
    tensors: nothing is allocated); the same step in float32 finds
    nothing; a small upcast is one info."""
    big = torch.empty(1 << 11, 1 << 11, dtype=torch.bfloat16, device="meta")
    f = shard_lint.lint_ops(_upcasts_of(lambda t: t.float().sum(), big),
                            subject="planted")
    assert [(x.check, x.severity) for x in f] == [
        ("bf16-upcast", "warning"), ("bf16-upcast", "info")]
    assert f[0].detail == {"shape": [2048, 2048], "elements": 1 << 22,
                           "sites": 1}
    f32 = big.to(torch.float32)
    assert shard_lint.lint_ops(_upcasts_of(
        lambda t: t.float().sum(), f32)) == []
    small = torch.empty(64, 64, dtype=torch.bfloat16, device="meta")
    f = shard_lint.lint_ops(_upcasts_of(lambda t: t.float() * 2, small))
    assert [x.severity for x in f] == ["info"]
    # the record's list form and a dict give the same findings
    rec = _upcasts_of(lambda t: t.float().sum(), big)
    as_list = [[list(s), c] for s, c in rec.upcasts.items()]
    assert shard_lint.lint_ops(as_list) == shard_lint.lint_ops(rec.upcasts)


def test_lint_ops_findings_follow_lint_jaxpr():
    """``lint_jaxpr``'s findings, written out from its source (under jax
    0.9 the reference's own call fails: ``jax.core.ClosedJaxpr`` is gone,
    one of the reference failures ROADMAP Queue 3 lists), on a step with
    the same upcasts: one warning a large shape with its site count,
    largest first, then one info over every site."""
    ta = torch.empty(2048, 2048, dtype=torch.bfloat16, device="meta")
    tb = torch.empty(16, 8, dtype=torch.bfloat16, device="meta")
    ours = shard_lint.lint_ops(_upcasts_of(
        lambda x, y: x.float().sum() + y.float().sum() + x.float().mean(),
        ta, tb), subject="s")
    want = [
        ranalysis.Finding(
            "bf16-upcast", "warning", "s",
            "bf16 -> f32 upcast of [2048, 2048] (4194304 elements) at 2 "
            "site(s) — 2x the HBM traffic the bf16 path budgets",
            {"shape": [2048, 2048], "elements": 4194304, "sites": 2}),
        ranalysis.Finding(
            "bf16-upcast", "info", "s",
            "3 bf16 -> f32 upcast site(s), 8388736 elements total",
            {"sites": 3, "elements": 8388736})]
    assert [dataclasses.asdict(x) for x in ours] == \
        [dataclasses.asdict(x) for x in want]
    assert shard_lint.UPCAST_WARN_ELEMENTS == rlint.UPCAST_WARN_ELEMENTS


@pytest.mark.parametrize("arch,profile", [("qwen2-1.5b", "2d"),
                                          ("qwen2-1.5b", "sp"),
                                          ("deepseek-v2-lite-16b", "expert"),
                                          ("gin-tu", "2d")])
def test_lint_cell_spec_findings_equal_the_reference(arch, profile):
    """Without the trace, ``lint_cell`` is the spec-tree lint of every
    argument: the same findings as the reference's ``lint_cell`` on the
    production axes, and as ``lint_spec_tree`` over the cell's arguments."""
    ours = shard_lint.lint_cell(arch, profile=profile, trace=False)
    theirs = rlint.lint_cell(arch, profile=profile, trace=False)
    assert [dataclasses.asdict(x) for x in ours] == \
        [dataclasses.asdict(x) for x in theirs]
    from repro_torch import configs
    from repro_torch.launch.steps import build_cell, rules_for
    a = configs.get(arch)
    shape = next(s for s in a.shapes.values() if s.kind != "skip")
    axes = ("pod", "data", "model")
    cell = build_cell(a, shape, rules_for(a.family, axes, profile=profile))
    direct = []
    for i, (x, spec) in enumerate(zip(cell["args"], cell["args_specs"])):
        direct.extend(shard_lint.lint_spec_tree(
            x, spec, axes, subject=f"{arch}/{shape.name}/{profile}:arg{i}"))
    assert ours == direct


def test_lint_cell_traces_on_one_device():
    """With the trace, the upcast findings of the step on one device
    follow the spec findings: AdamW's float32 copies of the bf16
    parameters, each layer's once."""
    over = {"n_layers": 2, "batch": 2, "seq": 16, "d_model": 64,
            "n_heads": 4, "n_kv_heads": 2, "d_ff": 128, "vocab": 4096}
    f = shard_lint.lint_cell("qwen2-1.5b", "train_4k", overrides=over)
    spec = shard_lint.lint_cell("qwen2-1.5b", "train_4k", overrides=over,
                                trace=False)
    assert f[:len(spec)] == spec
    ups = [x for x in f[len(spec):] if x.check == "bf16-upcast"]
    assert ups and ups[-1].severity == "info"
    assert not analysis.at_least(f, "error")
    skip = shard_lint.lint_cell("qwen2-1.5b", "long_500k")
    assert [x.check for x in skip] == ["cell-skip"]


ONE_DEVICE = {
    "qwen2-1.5b": {"n_layers": 2, "batch": 2, "seq": 32, "d_model": 64,
                   "n_heads": 4, "n_kv_heads": 2, "d_ff": 128, "vocab": 512},
    "deepseek-v2-lite-16b": {"n_layers": 2, "batch": 2, "seq": 32,
                             "d_model": 64, "n_heads": 4, "d_ff": 128,
                             "vocab": 512, "n_experts": 8, "top_k": 2,
                             "moe_d_ff": 32}}


@pytest.mark.parametrize("arch", list(ONE_DEVICE))
def test_one_device_step_does_not_depend_on_the_profile(arch):
    """``lint_cell`` traces a cell's step on one device once for all its
    profiles: there the arguments are plain meta tensors and the rules
    place nothing, so every profile's step runs the same ops, upcasts
    included. Each profile traced afresh; then ``lint_cell`` over every
    profile traces once and gives each the same upcast findings."""
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import build_cell, rules_for
    a, over = configs.get(arch), ONE_DEVICE[arch]
    axes = ("pod", "data", "model")
    seen = []
    for prof in a.profiles:
        with mesh_lib.fake_world(1):
            cell = build_cell(a, a.shapes["train_4k"], rules_for(
                a.family, axes, profile=prof), overrides=over)
            mesh = mesh_lib.make_mapped_mesh((1, 1, 1), axes)
            args = tuple(pl.meta_dtensors(x, sp, mesh) for x, sp in
                         zip(cell["args"], cell["args_specs"]))
            _, _, cost = pl.trace_step(cell["step"], args, mesh)
        seen.append((cost.totals, cost.upcasts, cost.n_ops))
    assert len(a.profiles) == 4 and all(x == seen[0] for x in seen)
    shard_lint._ONE_DEVICE_UPCASTS.clear()
    ups = []
    for prof in a.profiles:
        f = shard_lint.lint_cell(arch, "train_4k", profile=prof,
                                 overrides=over)
        ups.append([(x.check, x.severity, x.message) for x in f
                    if x.check == "bf16-upcast"])
    assert len(shard_lint._ONE_DEVICE_UPCASTS) == 1
    assert ups[0] and all(u == ups[0] for u in ups)
    assert shard_lint._ONE_DEVICE_UPCASTS[next(iter(
        shard_lint._ONE_DEVICE_UPCASTS))] == seen[0][1]


def test_cli_runs_a_topology_aware_cell_on_the_cpu(tmp_path, capsys):
    """``--device cpu``: one searched cell, its ``[OK]`` and ``[MAP]``
    lines, the reference-named JSON with the mapping report, non-empty
    ``hlo_cost`` and ``memory_analysis``, and the lint gate's findings,
    the kernel launch plans' among them."""
    out = tmp_path / "out"
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k",
                 "--machine", "gpu-superpod", "--topology-aware",
                 "--device", "cpu", "--cache-dir", "", "--out", str(out),
                 "--map-restarts", "2", "--lint"] + TINY_LM)
    text = capsys.readouterr().out
    assert "[OK]   qwen2-1.5b/train_4k/gpu-superpod" in text
    assert "[MAP]  qwen2-1.5b/train_4k/2d" in text
    assert "kernel-plan-pending" not in text and "0 error(s)" in text
    assert "kernels/flash_attention" in text
    r = json.loads((out / "qwen2-1.5b__train_4k__gpu-superpod.json")
                   .read_text())
    assert r["status"] == "ok" and r["mapping"]["makespan_ratio"] <= 1.0
    assert r["hlo_cost"]["flops"] > 0 and r["memory_analysis"]
    rep = dryrun._report_of(r)
    assert isinstance(rep, pl.PlacementReport)


def test_cli_needs_the_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k",
                     "--out", str(tmp_path)] + TINY_LM)


def test_diag_cell_runs_on_a_tiny_cell(monkeypatch):
    """The diagnosis twin on a tiny cell: its two tables, totals in
    seconds at the machine's own capacities (gpu-superpod: 450 GB/s links,
    3,350 GB/s HBM), call sites inside the port."""
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", [
        "torch_diag_cell.py", "--arch", "qwen2-1.5b", "--shape", "train_4k",
        "--machine", "gpu-superpod", "--top", "4"] + TINY_LM)
    with redirect_stdout(buf):
        runpy.run_path(str(ROOT / "scripts" / "torch_diag_cell.py"),
                       run_name="__main__")
    text = buf.getvalue()
    assert "== top collectives (link bytes, gpu-superpod) ==" in text
    assert "at 4.5e+11 B/s" in text and "at 3.35e+12 B/s" in text
    assert "repro_torch/" in text.split("== top HBM bytes")[1]


def test_diag_cell_script_imports_neither_jax_nor_the_reference():
    env = dict(os.environ, PYTHONPATH="src")
    code = ("import sys, runpy; sys.argv = ['x', '--help']\n"
            "try:\n    runpy.run_path('scripts/torch_diag_cell.py', "
            "run_name='__main__')\nexcept SystemExit:\n    pass\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\nprint(bad)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
