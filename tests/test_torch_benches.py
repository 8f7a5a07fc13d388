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


def _run_module(module, cwd, args=(), **env):
    env = dict(os.environ, REPRO_BENCH_DEVICE="cpu", REPRO_BENCH_TINY="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]),
               **env)
    out = subprocess.run([sys.executable, "-m", module, *args],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _run(bench, cwd):
    return _run_module(f"benchmarks.{bench}", cwd)


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


def test_torch_gnn_partitioned_training_runs_on_the_cpu(tmp_path):
    """The example end to end on the CPU with 20 of its 80 steps: the
    partition's hottest link carries less halo traffic than a hashed
    partition's, and GIN's loss on the placed graph falls."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable,
                          str(ROOT / "examples" /
                              "torch_gnn_partitioned_training.py"),
                          "--device", "cpu", "--steps", "20"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    halo = out.stdout.split("comm_max): partitioned=")[1]
    ours, hashed = float(halo.split()[0]), float(halo.split("hashed=")[1]
                                                 .split()[0])
    assert ours < hashed
    first, last = out.stdout.split("placed graph: loss ")[1].split()[0:3:2]
    assert float(last) < float(first)


@pytest.fixture(scope="module")
def placement_twin(tmp_path_factory):
    """The placement twin's tiny run on the CPU: its JSON."""
    cwd = tmp_path_factory.mktemp("placement_twin")
    _run("torch_bench_placement", cwd)
    return json.loads((cwd / "BENCH_torch_placement.json").read_text())


def test_placement_twin_writes_four_rows_and_holds_its_claims(
        placement_twin):
    """The four rows on the reference bench's generated inputs; the
    heterogeneous claims (the fast pod's FLOPs, the placed makespan at most
    the scatter's) raise inside the twin, and are read back here."""
    out = placement_twin
    assert out["tiny"] and out["device"] == "cpu"
    rows = {r["name"]: r for r in out["placement"]}
    assert list(rows) == ["moe_experts_32", "hetero_experts_32",
                          "embedding_rows_512", "bsr_locality_1024"]
    het = rows["hetero_experts_32"]
    assert het["fast_pod_flops"] >= het["slow_pod_flops"]
    assert het["makespan_ours"] <= het["makespan_scatter"]
    assert rows["moe_experts_32"]["win"] > 1.0
    assert rows["embedding_rows_512"]["hot_link_ours"] < \
        rows["embedding_rows_512"]["hot_link_hash"]
    for r in rows.values():
        assert all(np.isfinite(v) for v in r.values()
                   if isinstance(v, float))


# the tiny rows' numbers that no partition seed moves: the scatter and
# hash baselines score the bench's own draws, the unplaced layout's blocks
# are the graph's, and the reference puts all the experts' FLOPs on the
# fast pod
PLACEMENT_INPUT_ONLY = {
    "moe_experts_32": ("bottleneck_scatter", "makespan_scatter"),
    "hetero_experts_32": ("makespan_scatter", "fast_pod_flops",
                          "slow_pod_flops"),
    "embedding_rows_512": ("hot_device_hash", "hot_link_hash"),
    "bsr_locality_1024": ("blocks_before", "block_density_before"),
}


def test_placement_twin_inputs_equal_the_reference(placement_twin,
                                                   tmp_path):
    """The twin's numbers that no partition seed moves against the
    reference bench's tiny rows on the CPU (``bench_placement.py`` as a
    user runs it, its CSV lines rounded to 1 decimal, densities to 4):
    within half that rounding's unit plus rel 1e-6, so a twin that drew
    other traffic, frequencies, FLOPs or baselines fails."""
    out = _run_module("benchmarks.bench_placement", tmp_path,
                      JAX_PLATFORMS="cpu")
    ref = {ln.split(",")[1]: _fields(ln) for ln in out.splitlines()
           if ln.startswith("placement,")}
    got = {r["name"]: r for r in placement_twin["placement"]}
    assert sorted(ref) == sorted(got) == sorted(PLACEMENT_INPUT_ONLY)
    for name, keys in PLACEMENT_INPUT_ONLY.items():
        for key in keys:
            want = float(ref[name][key])
            unit = 1e-4 if key.startswith("block_density") else 0.1
            assert abs(got[name][key] - want) <= 0.5 * unit + \
                1e-6 * abs(want), (name, key, got[name][key], want)


def _reference_serving_rows():
    """The reference bench's continuous, static and placed rows at its tiny
    tier (``bench_serving.py``: 12 requests, 4 slots, prompts up to 8,
    generations up to 6, page 4), computed by its own ``_workload``,
    ``_serve`` and ``_row`` on the CPU. Its wall-clock claim is left out:
    at this size it compares two runs of tens of milliseconds."""
    import jax

    from benchmarks import bench_serving as ref
    from repro import configs
    from repro.dist.sharding import lm_rules
    from repro.models import transformer as tr
    cfg = configs.get("qwen2-1.5b").smoke_config()
    rules = lm_rules(())
    params, _ = tr.init(jax.random.PRNGKey(0), cfg, rules)
    work = ref._workload(cfg, 12, 8, 6)
    max_pages = -(-max(p.shape[0] + g for p, g in work) // 4)
    kw = dict(n_slots=4, page_size=4, n_pages=max_pages * 4 * 2,
              max_pages_per_req=max_pages, temperature=0.8, seed=0)
    runs = {"continuous_x4": {}, "static_x4": dict(static_batching=True),
            "continuous_placed_x4": dict(replace_every=8, place_devices=4)}
    return {name: ref._row(name, ref._serve(params, cfg, rules, work,
                                            **kw, **extra))
            for name, extra in runs.items()}


def test_serving_twin_schedule_equals_the_reference(tmp_path):
    """The twin (tiny, on the CPU, as a user runs it) against the reference
    bench's rows on the same stream: the continuous and static rows hold no
    placement, so every schedule field (steps, tokens, latency and TTFT in
    steps, occupancy) must be equal; the placed rows' schedules must equal
    the continuous row's. The chaos row's retries depend on where placement
    put the pages; the twin's own claims gate it. The twin's subprocess
    runs one intra-op thread, as the test processes do: its wall-clock
    claim compares runs of tens of milliseconds."""
    from benchmarks.torch_bench_serving import SCHEDULE
    want = _reference_serving_rows()
    _run_module("benchmarks.torch_bench_serving", tmp_path,
                OMP_NUM_THREADS="1")
    got = {r["name"]: r for r in json.loads(
        (tmp_path / "BENCH_torch_serving.json").read_text())["serving"]}
    assert list(got) == ["continuous_x4", "static_x4",
                         "continuous_placed_x4", "chaos_death_x4"]
    for name in ("continuous_x4", "static_x4"):
        assert {k: got[name][k] for k in SCHEDULE} == \
            {k: want[name][k] for k in SCHEDULE}, name
    for placed in (got, want):
        assert {k: placed["continuous_placed_x4"][k] for k in SCHEDULE} == \
            {k: got["continuous_x4"][k] for k in SCHEDULE}
    chaos = got["chaos_death_x4"]
    assert chaos["failed"] == 0 and chaos["tokens_out"] == \
        got["continuous_x4"]["tokens_out"]


def test_torch_run_prints_one_header(tmp_path):
    out = _run_module("benchmarks.torch_run", tmp_path,
                      ["--only", "placement"])
    lines = out.splitlines()
    assert lines.count("bench,name,us_per_call,derived") == 1
    assert lines[0] == "bench,name,us_per_call,derived"
    assert [ln.split(",")[1] for ln in lines
            if ln.startswith("placement,")] == [
        "moe_experts_32", "hetero_experts_32", "embedding_rows_512",
        "bsr_locality_1024"]
    assert lines[-1].startswith("# total ")


def test_torch_train_lm_100m_runs_on_the_cpu(tmp_path):
    """The example at 2 steps of 1 x 16 tokens: the ~97M model's size as
    the reference prints it, a finite loss (its own learned-assert passes)
    and the final checkpoint written."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable,
                          str(ROOT / "examples" / "torch_train_lm_100m.py"),
                          "--device", "cpu", "--steps", "2", "--batch", "1",
                          "--seq", "16", "--ckpt-dir", str(tmp_path / "ck")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "model: 97.5M params" in out.stdout
    first, last = out.stdout.split("loss: ")[1].split()[0:3:2]
    assert np.isfinite([float(first), float(last)]).all()
    assert (tmp_path / "ck" / "step_000000002").is_dir()


def test_torch_roofline_prints_the_references_table(tmp_path, monkeypatch,
                                                    capsys):
    """The roofline twin and the reference's ``benchmarks/roofline.py``
    print the same table from the same records: the port's dry-run of
    qwen2-1.5b/train_4k on the 16 x 16 production mesh at a tiny override
    and the skipped long_500k cell."""
    from benchmarks import roofline, torch_roofline
    from repro_torch.launch import dryrun
    from repro_torch.launch.placement import PlacementSession
    out = tmp_path / "dryrun_torch"
    session = PlacementSession(cache_dir="", device="cpu")
    dryrun.run_cell("qwen2-1.5b", "train_4k", False, out_dir=str(out),
                    overrides={"n_layers": 1, "batch": 16, "seq": 16},
                    session=session, device="cpu")
    dryrun.run_cell("qwen2-1.5b", "long_500k", False, out_dir=str(out))
    monkeypatch.setattr(roofline, "RESULTS", str(out))
    roofline.main()
    want = capsys.readouterr().out
    torch_roofline.main(str(out))
    got = capsys.readouterr().out
    assert got == want
    assert "# Roofline (1 baselined cells)" in got
    assert "| qwen2-1.5b | train_4k | " in got
    assert "| qwen2-1.5b | long_500k | N/A (skip" in got
