"""The port stands alone: no module under ``src/repro_torch/``, not
``chip_smoke.py`` and not the port's benchmark twins, examples and
scripts (``benchmarks/torch_bench_*.py``, their ``torch_common.py`` and
``torch_run.py``, ``examples/torch_*.py``, ``scripts/torch_*.py``) imports
``jax`` or the reference package ``repro`` (the card's machine has no
JAX), checked on the source's syntax tree."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "time_kernels.py", ROOT / "trace_gap.py",
    ROOT / "benchmarks" / "torch_common.py",
    ROOT / "benchmarks" / "torch_run.py"] + sorted(
    (ROOT / "benchmarks").glob("torch_bench_*.py")) + sorted(
    (ROOT / "examples").glob("torch_*.py")) + sorted(
    (ROOT / "scripts").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__",) and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_sources_exist():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for must in ("src/repro_torch/core/partitioner.py",
                 "src/repro_torch/kernels/ops.py", "chip_smoke.py",
                 "benchmarks/torch_bench_makespan_vs_cut.py",
                 "benchmarks/torch_bench_mapping_search.py",
                 "benchmarks/torch_bench_spmspv.py",
                 "benchmarks/torch_bench_tradeoff.py",
                 "benchmarks/torch_bench_hierarchical.py",
                 "benchmarks/torch_bench_variants.py",
                 "benchmarks/torch_bench_scaling.py",
                 "examples/torch_quickstart.py",
                 "src/repro_torch/tree.py", "src/repro_torch/optim/adamw.py",
                 "src/repro_torch/dist/compress.py",
                 "src/repro_torch/train/steps.py",
                 "src/repro_torch/train/loop.py",
                 "src/repro_torch/ckpt/checkpoint.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/resilience/faults.py",
                 "src/repro_torch/resilience/harness.py",
                 "src/repro_torch/embed/hot_cache.py",
                 "src/repro_torch/embed/training.py",
                 "src/repro_torch/embed/prefetch.py",
                 "benchmarks/torch_bench_embed.py",
                 "examples/torch_retrieval_serving.py",
                 "examples/torch_gnn_partitioned_training.py",
                 "src/repro_torch/configs/pna.py",
                 "src/repro_torch/configs/meshgraphnet.py",
                 "src/repro_torch/models/so3.py",
                 "src/repro_torch/models/equiformer.py",
                 "src/repro_torch/configs/equiformer_v2.py",
                 "benchmarks/torch_bench_placement.py",
                 "benchmarks/torch_bench_serving.py",
                 "benchmarks/torch_run.py",
                 "examples/torch_train_lm_100m.py",
                 "src/repro_torch/dist/sharding.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/launch/steps.py",
                 "src/repro_torch/launch/collectives.py",
                 "src/repro_torch/launch/placement.py",
                 "src/repro_torch/analysis/shard_lint.py",
                 "src/repro_torch/launch/op_cost.py",
                 "src/repro_torch/launch/dryrun.py",
                 "scripts/torch_diag_cell.py"):
        assert must in names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[p.relative_to(ROOT).as_posix() for p in SOURCES])
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_checker_sees_every_import_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.core import x\n"
                   "def f():\n    import jaxlib\n    __import__('repro')\n"
                   "from . import sibling\nimport repro_torch\n")
    assert sorted(set(imported_roots(src))) == ["jax", "jaxlib", "repro",
                                                "repro_torch"]
