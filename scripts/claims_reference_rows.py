"""The JAX reference's rows for the paper's remaining claims over seeds: the
bands the port's ``claims`` phase (``chip_smoke.py``) is held to.

The twin of ``scripts/c1_reference_rows.py`` for C2
(``benchmarks/bench_spmspv.py``), C3 (``bench_tradeoff.py``), C4
(``bench_hierarchical.py``), the section 3.1 variants
(``bench_variants.py``) and scaling (``bench_scaling.py``), at their full
tier. Each row is what the bench prints, computed as the bench computes it,
with ``seed`` in place of the bench's 0 for ``PartitionConfig.seed`` and
``CutRefineConfig.seed``. The BFS sources and the torus rows' random part
stay the bench's own ``default_rng(0)`` draws, so the scorers see the same
inputs at every seed. One JSON line per (claim, seed). Run on a CPU:

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/claims_reference_rows.py \\
        [--claims spmspv,tradeoff,hierarchical,variants] [--seeds 0,1,2,3]
    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/claims_reference_rows.py \\
        --claims scaling --seeds 0 [--scaling-rows size_10000,...]

``--scaling-rows`` picks scaling rows by name (``size_<n>``,
``k_<pods>x<rows>x<chips>``, ``vcycle_<m>``); the default is all of them.
``--bands`` reads such lines back (files of them, or ``-`` for standard
input) and prints the ``CLAIMS_REF`` and ``CLAIMS_TORUS`` literals of
``chip_smoke.py``: the least and largest of each checked number over the
lines' seeds (floored and ceiled at 4 decimals), and the torus rows.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

from benchmarks.bench_spmspv import bfs_round_cost
from benchmarks.common import spmv_step_time
from repro.core import baselines, reference
from repro.core.partitioner import PartitionConfig, partition
from repro.core.refine import RefineConfig, refine
from repro.core.topology import (balanced_tree, fat_tree_topology, make_tree,
                                 production_tree, torus2d_topology,
                                 with_bin_speed)
from repro.graph.generators import grid2d, grid3d, rmat, weighted_nodes


def spmspv(seed: int) -> dict:
    topo = balanced_tree((2, 4), level_cost=(6.0, 1.0))
    rows = {}
    for name, g in [("low_diam_rmat", rmat(4000, 24000, seed=3)),
                    ("high_diam_grid", grid2d(64, 64))]:
        ours = partition(g, topo, PartitionConfig(seed=seed)).part
        cut = baselines.total_cut_partition(
            g, topo.k, baselines.CutRefineConfig(seed=seed))
        srcs = np.random.default_rng(0).integers(0, g.n_nodes, 3)
        c_ours = float(np.mean([bfs_round_cost(g, topo, ours, int(s))
                                for s in srcs]))
        c_cut = float(np.mean([bfs_round_cost(g, topo, cut, int(s))
                               for s in srcs]))
        rows[name] = {"frontier_cost_ours": c_ours,
                      "frontier_cost_cut": c_cut,
                      "ratio": c_cut / max(c_ours, 1e-9)}
    return rows


def tradeoff(seed: int) -> dict:
    g = grid2d(48, 48)

    def mk(F):
        return balanced_tree((2, 4), F=F, level_cost=(6.0 * F, F))
    rows, comms = {}, []
    for F in (0.05, 0.2, 1.0, 5.0):
        topo = mk(F)
        res = partition(g, topo, PartitionConfig(seed=seed))
        s = baselines.score_all(g, topo, res.part)
        comms.append(s["comm_max"] / F)
        rows[f"makespan_F{F}"] = {"imbalance": s["imbalance"],
                                  "bottleneck_comm": s["comm_max"] / F,
                                  "makespan": s["makespan"]}
    for eps in (0.03, 0.10):
        cut = baselines.total_cut_partition(
            g, 8, baselines.CutRefineConfig(imbalance=eps, seed=seed))
        s = baselines.score_all(g, mk(1.0), cut)
        rows[f"cut_eps{eps}"] = {"imbalance": s["imbalance"],
                                 "bottleneck_comm": s["comm_max"],
                                 "makespan": s["makespan"]}
    rows["monotonic_comm_with_F"] = {"monotone": bool(all(
        comms[i] >= comms[i + 1] - 1e-6 for i in range(len(comms) - 1)))}
    return rows


def hierarchical(seed: int) -> dict:
    topo = production_tree(2, 4, 4)
    cfg = baselines.CutRefineConfig(seed=seed)
    rows = {}
    for name, g in [("grid3d_14", grid3d(14, 14, 14)),
                    ("rmat_10000", rmat(10000, 60000, seed=2))]:
        ours = partition(g, topo, PartitionConfig(seed=seed,
                                                  final_rounds=160))
        flat2 = baselines.flat_twice_partition(g, topo, cfg)
        hyb, _, _ = refine(g, topo, flat2, RefineConfig(rounds=96,
                                                        seed=seed))
        s_ours = spmv_step_time(g, topo, ours.part)
        s_flat = spmv_step_time(g, topo, flat2)
        s_hyb = spmv_step_time(g, topo, hyb)
        rows[name] = {"step_hier": s_ours["step"],
                      "step_flat_twice": s_flat["step"],
                      "step_hybrid": s_hyb["step"],
                      "ratio": s_flat["step"] / s_ours["step"],
                      "hybrid_vs_flat": s_flat["step"]
                      / max(s_hyb["step"], 1e-9)}
    return rows


def variants(seed: int) -> dict:
    cfg = PartitionConfig(seed=seed)
    rows = {}
    g = grid2d(32, 32)
    parent = [-1] + [0] * 4 + [1 + i // 4 for i in range(16)]
    rows["routers_16bins"] = {
        "makespan": partition(g, make_tree(parent), cfg).makespan}
    topo_f = fat_tree_topology(16, arity=4, uplink_speedup=2.0)
    cut = baselines.total_cut_partition(g, topo_f.k,
                                        baselines.CutRefineConfig(seed=seed))
    rows["fat_tree_Fl"] = {
        "makespan": partition(g, topo_f, cfg).makespan,
        "makespan_cut_baseline": baselines.score_all(g, topo_f,
                                                     cut)["makespan"]}
    g2 = rmat(2000, 9000, seed=4)
    rng = np.random.default_rng(0)
    for mp in (False, True):
        topo_t = torus2d_topology(4, 4, multipath=mp)
        part = rng.integers(0, topo_t.k, g2.n_nodes)
        m, _, comm = reference.makespan_routing_ref(part, g2, topo_t)
        rows[f"torus_multipath={mp}"] = {"makespan": float(m),
                                         "max_link": float(comm.max()),
                                         "total_link": float(comm.sum())}
    gw = weighted_nodes(rmat(3000, 15000, seed=5), seed=5, lo=0.1, hi=8.0)
    topo_w = balanced_tree((4, 4))
    res_w = partition(gw, topo_w, cfg)
    rows["vertex_weighted"] = {"makespan": res_w.makespan,
                               "comp_max": res_w.comp_max}
    topo_h = with_bin_speed(topo_w, [1.0] * 8 + [0.5] * 8)
    res_h = partition(gw, topo_h, cfg)
    raw = np.zeros(topo_h.k)
    np.add.at(raw, res_h.part, gw.node_weight)
    rows["hetero_speeds"] = {"makespan": res_h.makespan,
                             "fast_load": float(raw[:8].sum()),
                             "slow_load": float(raw[8:].sum())}
    return rows


def scaling(seed: int, only=None) -> dict:
    from repro.core import mapping, objective
    from repro.core.machine import resolve
    import jax.numpy as jnp
    rows = {}

    def wanted(name):
        return only is None or name in only
    topo = balanced_tree((2, 4, 4), level_cost=(8.0, 1.0, 1.0))
    for n, m in [(10_000, 60_000), (100_000, 600_000), (400_000, 2_400_000)]:
        if not wanted(f"size_{n}"):
            continue
        g = rmat(n, m, seed=0)
        t0 = time.time()
        res = partition(g, topo, PartitionConfig(
            seed=seed, refine=RefineConfig(rounds=32)))
        secs = time.time() - t0
        m_rand = baselines.score_all(g, topo, baselines.random_partition(
            n, topo.k))["makespan"]
        rows[f"size_{n}"] = {"makespan": res.makespan,
                             "vs_random": m_rand / res.makespan,
                             "partition_s": secs}
    g = grid2d(256, 256)
    for pods, rws, chips in [(1, 4, 4), (1, 16, 16), (2, 16, 16)]:
        name = f"k_{pods}x{rws}x{chips}"
        if not wanted(name):
            continue
        topo = production_tree(pods, rws, chips)
        t0 = time.time()
        res = partition(g, topo, PartitionConfig(
            seed=seed, refine=RefineConfig(rounds=24)))
        rows[name] = {"k": topo.k, "makespan": res.makespan,
                      "comp_max": res.comp_max, "comm_max": res.comm_max,
                      "partition_s": time.time() - t0}
    mtopo = resolve("torus-2d").topology()
    ptopo = balanced_tree((8, 8))
    for n, m in [(2_000, 10_000), (20_000, 100_000), (200_000, 1_000_000)]:
        if not wanted(f"vcycle_{m}"):
            continue
        g = rmat(n, m, seed=0)
        row = {}
        for backend in ("host", "device"):
            t0 = time.time()
            res = partition(g, ptopo, PartitionConfig(
                seed=seed, backend=backend, refine=RefineConfig(rounds=16)))
            W = np.array(objective.quotient_matrix(
                jnp.asarray(res.part, dtype=jnp.int32),
                jnp.asarray(g.senders), jnp.asarray(g.receivers),
                jnp.asarray(g.edge_weight), ptopo.k))
            np.fill_diagonal(W, 0.0)
            mres = mapping.search((8, 8), mtopo, W, n_random=8, seed=0)
            row[f"{backend}_makespan"] = res.makespan
            row[f"{backend}_bottleneck"] = float(mres.bottleneck)
            row[f"{backend}_s"] = time.time() - t0
        rows[f"vcycle_{m}"] = row
    return rows


# the numbers the claims phase holds to a band, by claim
CHECKED = {"spmspv": ("ratio",), "tradeoff": ("makespan",),
           "hierarchical": ("ratio", "hybrid_vs_flat"),
           "variants": ("makespan", "makespan_cut_baseline"),
           "scaling": ("makespan", "vs_random", "host_makespan",
                       "device_makespan", "host_bottleneck",
                       "device_bottleneck")}


def bands(lines) -> str:
    """The ``CLAIMS_REF`` and ``CLAIMS_TORUS`` literals from row lines."""
    ref, torus = {}, {}
    for ln in lines:
        d = json.loads(ln)
        for row, vals in d["rows"].items():
            if row.startswith("torus"):
                torus[row] = vals
                continue
            for key in CHECKED[d["claim"]]:
                if key in vals:
                    lo, hi = ref.get((d["claim"], row, key),
                                     (math.inf, -math.inf))
                    ref[(d["claim"], row, key)] = (min(lo, vals[key]),
                                                   max(hi, vals[key]))
    out = ["CLAIMS_REF.update({"]
    for (c, r, k), (lo, hi) in sorted(ref.items()):
        out.append(f"    ({c!r}, {r!r}, {k!r}): "
                   f"({math.floor(lo * 1e4) / 1e4!r}, "
                   f"{math.ceil(hi * 1e4) / 1e4!r}),")
    out.append("})")
    out.append(f"CLAIMS_TORUS.update({json.dumps(torus, sort_keys=True)})")
    return "\n".join(out)


CLAIMS = {"spmspv": spmspv, "tradeoff": tradeoff,
          "hierarchical": hierarchical, "variants": variants,
          "scaling": scaling}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--claims", default="spmspv,tradeoff,hierarchical,"
                                        "variants")
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--scaling-rows", default=None)
    ap.add_argument("--bands", nargs="*", default=None)
    args = ap.parse_args()
    if args.bands is not None:
        lines = []
        for path in args.bands or ["-"]:
            f = sys.stdin if path == "-" else open(path)
            lines += [ln for ln in f if ln.strip()]
        print(bands(lines))
        return
    only = (set(args.scaling_rows.split(",")) if args.scaling_rows
            else None)
    for claim in args.claims.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.time()
            rows = (scaling(seed, only) if claim == "scaling"
                    else CLAIMS[claim](seed))
            print(json.dumps({"claim": claim, "seed": seed,
                              "seconds": time.time() - t0, "rows": rows}),
                  flush=True)


if __name__ == "__main__":
    main()
