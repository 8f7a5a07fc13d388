#!/usr/bin/env python3
"""Time the port's workload kernels on one NVIDIA GPU at their paths'
shapes, with the checks and measurements of ``chip_smoke.py``'s kernels
phase: the partitioner's (``match_keys``, ``bucket_assign``,
``prefix_split``,
``quotient_link_loads`` on random and CSR-local partitions and at the serve
pools' k = 4, ``partition_gain`` beside ``scatter_add_``), the bag kernels
(``bag_combine``, ``gather_combine``) at the recsys path's shapes, with the
one-query alternation against their plain versions and library calls,
``bsr_spmm`` at the gnn path's and ``flash_attention``
at the lm paths' (one 4 x 4,096 prefill call, one of 32,768 tokens,
DeepSeek-V2-Lite's MLA call at D = 192, Dv = 128, and the reference's
MLA-like float32 case):

    python3 time_kernels.py [SRC] [--only partitioner,recsys,gnn,lm]

``SRC`` (default: this checkout's ``src``) is the directory holding the
``repro_torch`` package to time, so that two trees can be compared on one
card, one process each, in the order A, B, B, A. ``--only`` keeps the
named groups. ``prefix_split`` runs the kernels phase's ``prefix_split``
part alone (part of ``partitioner``): its checks, the kernel, the ATen
sequence it replaces and the old cumsum + ``bucket_assign`` pair timed in
alternation, and ``initial_partition_device``'s wall against the old
sequence's (either tree whose wrappers take this tree's arguments). Three
more are not in the default: ``full_qll`` times
``quotient_link_loads`` at each of the full cell's arc-count groups, on the
path's own inputs and on synthetic ones; ``serve`` runs the lm phase's two
serving streams for their ms per step, the wide one also unplaced (both
take either tree);
``qll_paths`` times ``quotient_link_loads`` with each of its launch shapes
forced, the data behind ``kernels/quotient_link_loads.py``'s
``SINGLE_BLOCK_ARCS``, ``ARCS_PER_BLOCK`` and ``BLOCKS_PER_SM`` (this
tree's only); ``bag_streams`` times the bulk lookup on four id streams
(its own, its hot rows spread over the table's pages, all on row 0,
uniform; either tree). Prints the card's ``nvidia-smi`` line and one JSON line per
kernel and shape; exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import chip_smoke


def qll_paths(state):
    """``quotient_link_loads`` on prefixes of ``grid3d(64, 64, 64)``'s
    CSR-ordered arcs, CSR-local (``arange(n) * k // n``) and random
    partitions: at k = 4, 8 and 64 and 1k-64k arcs with one block and with
    a grid forced (``SINGLE_BLOCK_ARCS``), and at the full cell's arc
    counts with each of ``ARCS_PER_BLOCK`` 2,048 / 4,096 / 8,192 and
    ``BLOCKS_PER_SM`` 1 / 2. Device µs per call, L2 flushed."""
    import torch

    from repro_torch.core.machine import MachineSpec
    from repro_torch.core.topology import balanced_tree, guess_tree
    from repro_torch.graph.generators import grid3d
    from repro_torch.kernels import quotient_link_loads as qll
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    g = grid3d(64, 64, 64)
    n = g.n_nodes
    s_all = torch.as_tensor(g.senders, device=dev)
    r_all = torch.as_tensor(g.receivers, device=dev)
    w_all = torch.as_tensor(g.edge_weight, device=dev)
    topos = {4: guess_tree(4), 8: balanced_tree((2, 4)),
             64: MachineSpec.preset("gpu-superpod").tree()}
    saved = (qll.SINGLE_BLOCK_ARCS, qll.ARCS_PER_BLOCK, qll.BLOCKS_PER_SM)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def time_one(m, k, kind, **consts):
        topo = topos[k]
        S = torch.as_tensor(topo.subtree, device=dev)
        F = torch.as_tensor(topo.F_l, device=dev)
        part = ((torch.arange(n, device=dev) * k // n).to(torch.int32)
                if kind == "csr_local" else
                torch.randint(0, k, (n,), generator=gen, device=dev,
                              dtype=torch.int32))
        s, r, w = s_all[:m], r_all[:m], w_all[:m]
        for name, value in consts.items():
            setattr(qll, name, value)
        try:
            path = qll.qll_path(m, k, sms)
            got = qll.quotient_link_loads(part, s, r, w, S, F, k)
            ok = bool(torch.allclose(got, qll.plain(part, s, r, w, S, F, k),
                                     rtol=1e-4, atol=1e-3))
            ms = chip_smoke.device_ms(
                lambda: qll.quotient_link_loads(part, s, r, w, S, F, k), 30,
                flush=chip_smoke._flush_buffer(state))
        finally:
            (qll.SINGLE_BLOCK_ARCS, qll.ARCS_PER_BLOCK,
             qll.BLOCKS_PER_SM) = saved
        chip_smoke.emit("qll_paths", m=m, k=k, input=kind,
                        path=path._asdict(), us=ms * 1e3, matches_plain=ok,
                        **consts)
        if not ok:
            raise AssertionError(f"qll_paths: {m, k, kind, consts} disagrees "
                                 f"with the plain version")

    for k in (4, 8, 64):
        for m in (1024, 2048, 4096, 8192, 16384, 32768, 65536):
            for kind in ("csr_local", "random"):
                time_one(m, k, kind, SINGLE_BLOCK_ARCS=1 << 30)
                time_one(m, k, kind, SINGLE_BLOCK_ARCS=0)
    for m in (122_656, 499_342, 1_548_288):
        for kind in ("csr_local", "random"):
            for per_block in (2048, 4096, 8192):
                for per_sm in (1, 2):
                    time_one(m, 64, kind, ARCS_PER_BLOCK=per_block,
                             BLOCKS_PER_SM=per_sm)


def full_qll(state):
    """``quotient_link_loads`` at each arc-count group of the full cell
    (``grid3d(64, 64, 64)`` on gpu-superpod, device backend, seed 0): one
    ``partition()`` records each group's largest call, which is timed on
    its own inputs and on random and CSR-local inputs of its shape
    (``chip_smoke.qll_by_shape``)."""
    from repro_torch.core.machine import MachineSpec
    from repro_torch.core.partitioner import PartitionConfig, partition
    from repro_torch.graph.generators import grid3d
    from repro_torch.kernels import ops, quotient_link_loads
    g = grid3d(64, 64, 64)
    topo = MachineSpec.preset("gpu-superpod").tree()
    cfg = PartitionConfig(seed=0, backend="device")
    partition(g, topo, cfg)
    ops.reset_launch_counts()
    path_inputs = chip_smoke.record_qll_inputs(
        lambda: partition(g, topo, cfg))
    shapes = dict(quotient_link_loads.launch_shapes)
    for group in chip_smoke.qll_by_shape(state, shapes, path_inputs):
        chip_smoke.emit("full_qll", **group)


def serve(state):
    """The lm phase's two serving streams (``chip_smoke.LM_SERVE`` and
    ``LM_WIDE``: qwen2-1.5b at full width from seed 0, placement on) end to
    end, untraced, and the wide one again with placement off (no
    partitioner call: the same code in any two trees, so its spread is the
    server's own): wall ms per engine step, ``map_pages`` seconds and the
    partitioner kernels' launches, so that two trees' servers can be
    compared on one card."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    dev = torch.device("cuda")
    cfg = configs.get(chip_smoke.LM_ARCH).make_config("decode_32k")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = tr.init(cfg, gen, device=dev)
    for name, workload, policy in (
            ("serve", chip_smoke.LM_SERVE, chip_smoke.LM_SERVE_POLICY),
            ("serve_wide", chip_smoke.LM_WIDE, chip_smoke.LM_WIDE_POLICY),
            ("serve_wide_unplaced", chip_smoke.LM_WIDE,
             dict(chip_smoke.LM_WIDE_POLICY, replace_every=0))):
        ops.reset_launch_counts()
        eng, n_gen = chip_smoke._serve_engine(
            params, cfg, workload, temperature=chip_smoke.LM_TEMPERATURE,
            **policy)
        line = chip_smoke._serve_line(eng, eng.run(), n_gen)
        chip_smoke.emit("serve", step=name, launches=ops.launch_counts(),
                        **{k: line[k] for k in (
                            "step_ms_p50", "step_ms_p99", "step_ms_mean",
                            "map_pages_calls", "map_pages_s")})


def bag_streams(state):
    """serve_bulk's lookup (float32 and bf16, 262,144 bags of 50 on the
    1M x 256 table) on four id streams: its own (Zipf, padding on row 0);
    the same ids through a bijection of [0, V) (``id * 7919 % V``: every
    cache sees the same reuse, but the hot rows, the Zipf stream's low ids,
    spread from the table's first pages over all of it); every slot on row
    0 (every load after the first hits L1: the kernel's cost without its
    misses); and uniform ids (almost no reuse: every slot's row from L2 or
    device memory). Timed in alternation (one call each per round, L2
    flushed first; median and quartiles)."""
    import torch

    from repro_torch.configs.two_tower_retrieval import FULL, SHAPES
    from repro_torch.kernels import gather_combine as gc
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    table = torch.randn(FULL.n_items, FULL.embed_dim, generator=gen,
                        device=dev) * 0.01
    req = chip_smoke.recsys_request(FULL.n_items, FULL.n_cats,
                                    SHAPES["serve_bulk"].meta["batch"])
    idx, w = req["user_hist"].clamp_min(0), req["w"]
    streams = {
        "ids": idx,
        "spread_ids": (idx.long() * 7919 % FULL.n_items).to(torch.int32),
        "row_0": torch.zeros_like(idx),
        "uniform": torch.randint(0, FULL.n_items, idx.shape, generator=gen,
                                 device=dev, dtype=torch.int32)}
    for dtype in (torch.float32, torch.bfloat16):
        tbl = table.to(dtype)
        stats = chip_smoke.alternating_device_ms(
            [lambda i=i: gc.gather_combine(tbl, i, w)
             for i in streams.values()],
            rounds=5, flush=chip_smoke._flush_buffer(state))
        chip_smoke.emit("bag_streams", shape="serve_bulk", dtype=str(dtype),
                        **dict(zip(streams, stats)))
        del tbl


GROUPS = {"partitioner": chip_smoke.phase_kernels,
          "recsys": chip_smoke.phase_kernels_recsys,
          "gnn": chip_smoke.phase_kernels_gnn,
          "lm": chip_smoke.phase_kernels_lm,
          "prefix_split": chip_smoke.phase_kernels_split,
          "qll_paths": qll_paths, "full_qll": full_qll, "serve": serve,
          "bag_streams": bag_streams}


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=None)
    ap.add_argument("--only", default="partitioner,recsys,gnn,lm")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))
    state = {"launches": {}}
    chip_smoke.phase_env(state)
    chip_smoke.phase_build(state)
    for name in args.only.split(","):
        GROUPS[name](state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
