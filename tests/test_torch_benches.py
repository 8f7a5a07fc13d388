"""The port's bench twins (``benchmarks/torch_bench_*.py``) run end to end
on the CPU at their tiny sizes, as a user runs them:

    REPRO_BENCH_DEVICE=cpu REPRO_BENCH_TINY=1 PYTHONPATH=src \\
        python -m benchmarks.torch_bench_<name>

Each runs in a process of its own (the sizes are read at import)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(bench, cwd):
    env = dict(os.environ, REPRO_BENCH_DEVICE="cpu", REPRO_BENCH_TINY="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-m", f"benchmarks.{bench}"],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _fields(line):
    return dict(kv.split("=") for kv in line.split(",", 3)[3].split())


def test_makespan_vs_cut_twin_prints_one_row_per_case(tmp_path):
    rows = [ln for ln in _run("torch_bench_makespan_vs_cut",
                              tmp_path).splitlines()
            if ln.startswith("C1_makespan_vs_cut,")]
    assert [r.split(",")[1] for r in rows] == ["grid2d_16", "grid3d_6",
                                               "rmat_2000"]
    for r in rows:
        f = {k: float(v) for k, v in _fields(r).items()}
        assert np.isfinite(list(f.values())).all()
        assert f["speedup_vs_cut"] == pytest.approx(
            f["step_cut"] / f["step_ours"], rel=1e-2)
        # the random assignment is no partitioner's match
        assert f["step_rand"] > max(f["step_ours"], f["step_cut"])


def test_mapping_search_twin_writes_its_rows(tmp_path):
    _run("torch_bench_mapping_search", tmp_path)
    out = json.loads((tmp_path / "BENCH_torch_mapping_search.json")
                     .read_text())
    assert out["tiny"] and out["device"] == "cpu"
    assert [r["mesh"] for r in out["scoring"]] == ["2x4", "2x2x4"]
    assert [r["name"] for r in out["machines"]] == ["gpu-superpod",
                                                    "tpu-mixed-32"]
    for r in out["machines"]:
        assert r["makespan_searched"] <= r["makespan_id"]
        assert r["cap_searched"] <= r["cap_id"]
    assert out["partition_seeds"]["makespan_S"] <= \
        out["partition_seeds"]["makespan_1"]


def _rows(out, bench):
    return {ln.split(",")[1]: {k: v for k, v in _fields(ln).items()}
            for ln in out.splitlines() if ln.startswith(bench + ",")}


def test_spmspv_twin_prints_both_cases(tmp_path):
    rows = _rows(_run("torch_bench_spmspv", tmp_path), "C2_spmspv")
    assert list(rows) == ["low_diam_rmat", "high_diam_grid"]
    for f in rows.values():
        ours, cut = float(f["frontier_cost_ours"]), float(f["frontier_cost_cut"])
        assert ours > 0 and cut > 0
        assert float(f["ratio"]) == pytest.approx(cut / ours, rel=1e-2)


def test_tradeoff_twin_prints_the_sweep_and_the_cut_points(tmp_path):
    rows = _rows(_run("torch_bench_tradeoff", tmp_path), "C3_tradeoff")
    assert list(rows) == ["makespan_F0.05", "makespan_F0.2",
                          "makespan_F1.0", "makespan_F5.0", "cut_eps0.03",
                          "cut_eps0.1", "monotonic_comm_with_F"]
    for name, f in rows.items():
        if name.startswith(("makespan", "cut")):
            assert float(f["makespan"]) > 0 and float(f["imbalance"]) >= 0
    assert rows["monotonic_comm_with_F"]["monotone"] in ("True", "False")


def test_hierarchical_twin_prints_both_cases(tmp_path):
    rows = _rows(_run("torch_bench_hierarchical", tmp_path),
                 "C4_hierarchical")
    assert list(rows) == ["grid3d_6", "rmat_1000"]
    for f in rows.values():
        assert float(f["ratio"]) == pytest.approx(
            float(f["step_flat_twice"]) / float(f["step_hier"]), rel=1e-2)


def test_variants_twin_writes_its_rows(tmp_path):
    _run("torch_bench_variants", tmp_path)
    out = json.loads((tmp_path / "BENCH_torch_variants.json").read_text())
    assert out["tiny"] and out["device"] == "cpu"
    rows = {r["name"]: r for r in out["variants"]}
    assert list(rows) == ["routers_16bins", "fat_tree_Fl",
                          "torus_multipath=False", "torus_multipath=True",
                          "vertex_weighted", "hetero_speeds"]
    assert rows["routers_16bins"]["n_routers"] == 5
    # multipath spreads the same traffic over more links
    assert (rows["torus_multipath=True"]["max_link"]
            <= rows["torus_multipath=False"]["max_link"])
    assert rows["hetero_speeds"]["fast_load"] > rows["hetero_speeds"][
        "slow_load"]


def test_scaling_twin_writes_its_rows(tmp_path):
    _run("torch_bench_scaling", tmp_path)
    out = json.loads((tmp_path / "BENCH_torch_scaling.json").read_text())
    assert out["tiny"] and out["device"] == "cpu"
    assert [r["name"] for r in out["size"]] == ["size_2000"]
    assert [r["k"] for r in out["k"]] == [16, 256]
    (v,) = out["vcycle"]
    assert v["name"] == "vcycle_3000"
    for backend in ("host", "device"):
        assert v[f"{backend}_makespan"] > 0
        assert v[f"{backend}_bottleneck"] > 0


def test_torch_quickstart_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable,
                          str(ROOT / "examples" / "torch_quickstart.py"),
                          "--device", "cpu"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = {ln.split(":")[0].strip(): ln for ln in out.stdout.splitlines()
             if ":" in ln}
    ours = float(lines["makespan-opt"].split("M(P)=")[1].split()[0])
    for base in ("cut-opt", "random"):
        assert float(lines[base].split("M(P)=")[1].split()[0]) > ours
    assert "block placement" in lines and "tpu-mixed-32" in lines


def test_embed_twin_holds_its_gates_and_writes_its_rows(tmp_path):
    _run("torch_bench_embed", tmp_path)
    out = json.loads((tmp_path / "BENCH_torch_embed.json").read_text())
    assert out["tiny"] and out["device"] == "cpu"
    rows = {r["name"]: r for r in out["embed"]}
    assert list(rows) == ["replicated", "sharded", "sharded_cache",
                          "sharded_cache_prefetch"]
    assert rows["sharded_cache"]["traffic_bytes"] < \
        rows["replicated"]["traffic_bytes"]
    assert rows["sharded_cache_prefetch"]["max_occupancy"] >= 1
    assert rows["sharded_cache"]["hit_rate"] > 0.3


def test_torch_retrieval_serving_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable,
                          str(ROOT / "examples" /
                              "torch_retrieval_serving.py"),
                          "--device", "cpu", "--steps", "20"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    first, last = out.stdout.split("train: loss ")[1].split()[0:3:2]
    assert float(last) < float(first)
    assert "scored 128 pairs" in out.stdout
    assert "top-10 of 100000 candidates" in out.stdout
