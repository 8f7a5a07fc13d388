"""Roofline table of the port's dry-run: twin of ``benchmarks/roofline.py``.

Reads the records ``repro_torch.launch.dryrun`` writes (one JSON a cell,
with the reference's keys) from ``results/dryrun_torch/`` and prints the
three-term roofline table per (arch x shape) for each production mesh, as
markdown, the reference's table line for line.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
    PYTHONPATH=src python -m benchmarks.torch_roofline
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

RESULTS = os.path.join(os.path.dirname(__file__), "..", "results",
                       "dryrun_torch")
MESHES = ("16x16", "2x16x16")


def load(tag: str = "", results: Optional[str] = None) -> List[Dict]:
    """The records under ``results`` (default ``results/dryrun_torch``)
    whose ``tag`` is ``tag``, in file-name order."""
    rows = []
    for path in sorted(glob.glob(os.path.join(results or RESULTS,
                                              "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("tag", "") == tag:
            rows.append(r)
    return rows


def fmt(x, digits: int = 3) -> str:
    if x is None:
        return "-"
    if x == 0:
        return "0"
    return (f"{x:.{digits}e}" if (abs(x) < 1e-2 or abs(x) > 1e4)
            else f"{x:.{digits}f}")


def table(rows: List[Dict], mesh: str = "16x16") -> str:
    """The markdown table of ``rows`` on ``mesh``: the compute, memory and
    collective terms, the dominant one, the bound, the roofline fraction,
    the useful-FLOP ratio and the argument bytes a device holds."""
    out = ["| arch | shape | comp (s) | mem (s) | coll (s) | dominant | "
           "bound (s) | roofline | useful | GB/dev |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | N/A (skip: full "
                       f"attention at 500k) | | | | | | | |")
            continue
        t = r["roofline_terms"]
        mem_gb = (r["memory_analysis"].get("argument_bytes") or 0) / 1e9
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt(t['compute_s'])} | "
            f"{fmt(t['memory_s'])} | {fmt(t['collective_s'])} | "
            f"{r['dominant'].replace('_s', '')} | "
            f"{fmt(r['step_time_bound_s'])} | "
            f"{fmt(r.get('roofline_fraction'), 2)} | "
            f"{fmt(r.get('useful_ratio'), 2)} | {mem_gb:.2f} |")
    return "\n".join(out)


def main(results: Optional[str] = None) -> None:
    rows = load(results=results)
    ok = [r for r in rows if r["status"] == "ok"]
    print(f"# Roofline ({len(ok)} baselined cells)")
    for mesh in MESHES:
        print(f"\n## mesh {mesh}\n")
        print(table(rows, mesh))


if __name__ == "__main__":
    main()
