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
