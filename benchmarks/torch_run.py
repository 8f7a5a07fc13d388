"""Benchmark suite runner of the port: one section per paper table or
claim, over the port's bench twins. Twin of ``benchmarks/run.py``.

    PYTHONPATH=src python -m benchmarks.torch_run [--fast] [--only NAME]
    REPRO_BENCH_DEVICE=cpu REPRO_BENCH_TINY=1 PYTHONPATH=src \\
        python -m benchmarks.torch_run --only placement

Prints ``bench,name,us_per_call,derived...`` CSV rows under one header,
then, as the reference's ``run.py`` does, the roofline table of the
dry-run records when ``results/dryrun_torch`` holds any
(``benchmarks/torch_roofline.py``; ``python -m repro_torch.launch.dryrun``
writes them).
"""
from __future__ import annotations

import argparse
import os
import time


def suites(fast: bool) -> dict:
    """Section name -> the twin's ``run``; ``scaling`` unless ``fast``."""
    from benchmarks import (torch_bench_hierarchical,
                            torch_bench_makespan_vs_cut,
                            torch_bench_placement, torch_bench_spmspv,
                            torch_bench_tradeoff, torch_bench_variants)
    out = {
        "C1": torch_bench_makespan_vs_cut.run,
        "C2": torch_bench_spmspv.run,
        "C3": torch_bench_tradeoff.run,
        "C4": torch_bench_hierarchical.run,
        "variants": torch_bench_variants.run,
        "placement": torch_bench_placement.run,
    }
    if not fast:
        from benchmarks import torch_bench_scaling
        out["scaling"] = torch_bench_scaling.run
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="skip the large scaling benchmark")
    ap.add_argument("--only", default=None)
    args = ap.parse_args(argv)

    print("bench,name,us_per_call,derived")
    t0 = time.time()
    for name, fn in suites(args.fast).items():
        if args.only and name != args.only:
            continue
        t = time.time()
        fn()
        print(f"# {name} done in {time.time() - t:.1f}s", flush=True)
    from benchmarks import torch_roofline
    if os.path.isdir(torch_roofline.RESULTS) and os.listdir(
            torch_roofline.RESULTS):
        print()
        torch_roofline.main()
    print(f"# total {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
