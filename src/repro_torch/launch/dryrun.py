"""The dry-run: trace every (arch x shape x mesh) cell on a fake world of
the machine's size and extract the three roofline terms. Twin of
``repro/launch/dryrun.py``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k [--multi-pod] [--machine <preset>] \\
        [--out results/dryrun_torch] [--profile 2d|fsdp|sp|expert] \\
        [--topology-aware] [--recompile] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mapping-grid

``--machine`` names a ``core.machine.MachineSpec`` preset: the mesh shape,
its axes, the scored topology and the per-leaf roofline capacities all
come from the spec. A heterogeneous machine (``tpu-mixed-32``) reports
the slowest bin's terms and each term's range over the bins.

Methodology (the reference's, on the port's trace):
  * the cell is traced once by ``launch.placement.PlacementSession``: the
    step runs on meta DTensors over a ``fake`` process group of the
    machine's size, under the collective recorder
    (``launch/collectives.py``) and the op-cost recorder
    (``launch/op_cost.py``);
  * collective bytes: each collective's ring-model per-device link bytes
    (all-gather F(S-1)/S, all-reduce 2F(S-1)/S, reduce-scatter F(S-1)/S,
    all-to-all F(S-1)/S); the port's layers are unrolled, so every trip is
    recorded and nothing is scaled;
  * FLOPs and bytes: the op-cost recorder's per-device totals, each op as
    one device runs it on its local shards. The HBM term is the tight op
    set (products, gathers and scatters, sorts, reductions, collectives,
    custom kernels), as the reference's. The attention already counts as
    its fused kernel's Q/K/V/O I/O (a declared kernel site), so nothing
    is swapped out of the record (``bytes_attn_xla`` is 0) and the
    reference's ``attention_kernel_bytes`` is reported beside it;
  * mapping search (``--topology-aware`` / ``--mapping-grid``): the
    placement session's search over the machine tree, on ``--device``
    (the card unless ``--device cpu``; its scorer launches
    ``quotient_link_loads``), and with ``--recompile`` the retrace under
    the searched order to a fixed point. Traces go through the session's
    keyed cache (``--cache-dir``).

The terms are seconds only at the capacities of the machine named;
capacities come from the ``MachineSpec`` and nothing else.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, configs, resolve_device
from repro_torch.core import machine as machine_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_cost
from repro_torch.launch import placement
from repro_torch.launch.steps import build_cell, rules_for


def _trace(arch, shape, mesh, overrides=None, grad_compress=False,
           profile: str = "2d",
           cost: Optional[op_cost.OpCostRecorder] = None):
    """Trace one cell on an explicit ``DeviceMesh`` of the current (fake)
    process group, uncached: ``(cell, op-cost recorder, collective
    recorder)``. The twin of the reference's ``_compile``
    (``scripts/torch_diag_cell.py``'s entry; the dry-run itself goes
    through the placement session's cached path). ``cost`` may carry
    options (``call_sites=True``)."""
    rules = rules_for(arch.family, tuple(mesh.mesh_dim_names),
                      profile=profile)
    cell = build_cell(arch, shape, rules, grad_compress=grad_compress,
                      overrides=overrides)
    args = tuple(placement.meta_dtensors(a, s, mesh) for a, s in
                 zip(cell["args"], cell["args_specs"]))
    rec, _, cost = placement.trace_step(cell["step"], args, mesh, cost=cost)
    return cell, cost, rec


def lm_train_args(arch_name: str, shape_name: str,
                  overrides: Optional[Dict] = None, device: DeviceLike = None,
                  seed: int = 0):
    """``(cell, args)``: an LM train cell (:func:`build_cell`, no mesh)
    and its arguments on ``device`` (``None`` = CUDA), the parameters from
    ``init`` and the batch's tokens and labels drawn from one generator
    seeded ``seed``, AdamW's state from ``adamw.init``: the step the trace
    counts, to run for real."""
    import dataclasses as dc

    from repro_torch.launch.steps import opt_config
    from repro_torch.models import transformer as tr
    from repro_torch.optim import adamw

    arch = configs.get(arch_name)
    shape = arch.shapes[shape_name]
    cell = build_cell(arch, shape, rules_for(arch.family, ()),
                      overrides=overrides)
    over = dict(overrides or {})
    meta = {**shape.meta, **{k: over.pop(k) for k in list(over)
                             if k in shape.meta}}
    cfg = arch.make_config(shape_name)
    cfg = dc.replace(cfg, **{k: v for k, v in over.items()
                             if hasattr(cfg, k)})
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tr.init(cfg, gen, device=dev)
    b, s = meta["batch"], meta["seq"]
    batch = {k: torch.randint(0, cfg.vocab, (b, s), generator=gen,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    return cell, (params, adamw.init(params, opt_config()), batch)


def attention_kernel_bytes(arch, shape) -> float:
    """Whole-network per-step HBM bytes of attention run as the fused
    kernel (``kernels/flash_attention.py``): Q/K/V read and O written,
    and in the backward the recompute's reads and dQ/dK/dV writes; the
    score tiles never leave the chip. The reference's formula, at the
    config's own dtype (the reference assumes bf16)."""
    if arch.family != "lm" or shape.kind not in ("train", "prefill"):
        return 0.0
    cfg = arch.make_config(shape.name)
    b, s = shape.meta["batch"], shape.meta["seq"]
    bpe = torch.empty((), dtype=cfg.dtype).element_size()
    if cfg.mla:
        dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        q = b * s * cfg.n_heads * dqk
        k = b * s * cfg.n_heads * dqk
        v = b * s * cfg.n_heads * cfg.v_head_dim
        o = v
    else:
        dh = cfg.head_dim
        q = b * s * cfg.n_heads * dh
        k = b * s * cfg.n_kv_heads * dh
        v = k
        o = q
    fwd = (q + k + v + o) * bpe
    factor = 3.0 if shape.kind == "train" else 1.0   # bwd rereads + writes
    return cfg.n_layers * fwd * factor


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None, grad_compress=False,
             tag: str = "", profile: str = "2d",
             overrides: Optional[Dict] = None,
             topology_aware: bool = False, map_restarts: int = 32,
             recompile: bool = False,
             session: Optional[placement.PlacementSession] = None,
             machine=None, device: DeviceLike = None) -> Dict:
    """One (arch x shape x mesh) cell through the placement session: trace
    (or a cache hit), the roofline terms, and with ``topology_aware`` the
    searched-vs-identity mapping comparison (on ``device``, ``None`` =
    CUDA), retraced under the searched order when ``recompile`` is set.
    The result has every key of the reference's.

    ``machine`` (a ``MachineSpec`` or preset name) selects the machine
    model; the default is the TPU production preset ``multi_pod`` names.
    Terms are sized per leaf, so a heterogeneous machine reports the
    binding (slowest-bin) time and the per-bin range.

    The reference compiles LM train and prefill cells with ``q_chunk``
    0, so that XLA's kv-chunk loop is the only loop nested under the
    layer scan (its ``bytes_deep``). The port's attention counts as one
    kernel call whatever its chunking (query rows padded to whole chunks:
    the same count where the chunk divides the sequence), so the cell
    runs at its config's chunking and shares the session's records.
    """
    arch = configs.get(arch_name)
    shape = arch.shapes[shape_name]
    spec = (machine_lib.resolve(machine)
            or mesh_lib.production_machine(multi_pod))
    # the TPU production presets keep the historical shape tags; every
    # other machine tags by name (gpu-superpod and torus-2d share 8x8)
    mesh_tag = ("x".join(str(s) for s in spec.mesh_shape)
                if spec.name in ("tpu_v5e-256", "tpu_v5e-512")
                else spec.name)
    result: Dict = {"arch": arch_name, "shape": shape_name, "mesh": mesh_tag,
                    "machine": spec.name, "kind": shape.kind, "tag": tag,
                    "profile": profile}
    if shape.kind == "skip":
        result["status"] = "skip"
        result["reason"] = shape.skip_reason
        return _emit(result, out_dir)

    session = session or placement.PlacementSession(
        map_restarts=map_restarts, device=device)
    topology_aware = topology_aware or recompile   # recompile implies it
    chips = spec.n_devices
    if topology_aware:
        res = session.place(arch_name, shape_name, machine=spec,
                            profile=profile, grad_compress=grad_compress,
                            overrides=overrides, recompile=recompile)
        rec = res.record
        result["mapping"] = dataclasses.asdict(res.report)
    else:
        rec = session.measure(arch_name, shape_name, machine=spec,
                              profile=profile, grad_compress=grad_compress,
                              overrides=overrides)
    cal, bytes_deep = rec.hlo_cal, rec.bytes_deep

    flops_dev = max(cal["flops"], rec.agg_flops)
    # HBM proxy = the tight op set; the attention's kernel I/O is in it
    # already (op_cost's declared site), so bytes_deep (0) swaps nothing
    bytes_dev = cal["bytes_tight"] - bytes_deep
    attn_dev = attention_kernel_bytes(arch, shape) / chips
    bytes_all_dev = max(cal["bytes"], rec.agg_bytes)
    link_dev = float(sum(rec.link_bf16.values()))
    model_fl = arch.model_flops(shape.name)

    # per-leaf roofline: SPMD shards are equal, so a bin's time is the
    # shard cost over its capacity and the step is bound by the slowest bin
    compute_s_bins = flops_dev / spec.peak_flops
    memory_s_bins = bytes_dev / spec.hbm_bw
    compute_s = float(compute_s_bins.max())
    memory_s = float(memory_s_bins.max())
    collective_s = link_dev / spec.link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    if spec.heterogeneous:
        result["roofline_per_bin"] = {
            "compute_s_min": float(compute_s_bins.min()),
            "compute_s_max": compute_s,
            "memory_s_min": float(memory_s_bins.min()),
            "memory_s_max": memory_s,
            "slowest_bin": int(np.argmax(
                np.maximum(compute_s_bins, memory_s_bins))),
        }
    result.update({
        "status": "ok",
        "chips": chips,
        "compile_s": rec.compile_s, "calibrate_s": rec.calibrate_s,
        "cache_hit": rec.cached,
        "per_device": {"flops": flops_dev, "bytes": bytes_dev,
                       "bytes_unfused": bytes_all_dev,
                       "bytes_attn_xla": bytes_deep,
                       "bytes_attn_kernel": attn_dev,
                       "collective_link_bytes": rec.link_bf16,
                       "collective_link_bytes_raw_f32": rec.link,
                       "collective_operand_bytes": rec.operand,
                       "n_collectives": rec.n_collectives},
        "total": {"flops": flops_dev * chips, "bytes": bytes_dev * chips,
                  "collective_link_bytes": link_dev * chips},
        "agg_once": {"flops": rec.agg_flops, "bytes": rec.agg_bytes},
        "hlo_cost": cal,
        "memory_analysis": rec.memory,
        "model_flops": model_fl,
        "useful_ratio": (model_fl / (flops_dev * chips)
                         if flops_dev else None),
        "roofline_terms": terms,
        "dominant": dominant,
        "step_time_bound_s": bound,
        "roofline_fraction": (compute_s / bound if bound > 0 else None),
        "scan_lengths": rec.scan_lengths,
    })
    return _emit(result, out_dir)


def _emit(result: Dict, out_dir: Optional[str]) -> Dict:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"__{result['tag']}" if result.get("tag") else ""
        name = (f"{result['arch']}__{result['shape']}"
                f"__{result['mesh']}{tag}.json")
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(result, f, indent=1)
    return result


def _report_of(result: Dict) -> placement.PlacementReport:
    return placement.PlacementReport(**result["mapping"])


def mapping_grid(arch_names: List[str], shape_name: str, out_dir: str,
                 overrides: Optional[Dict] = None,
                 map_restarts: int = 32, recompile: bool = False,
                 session: Optional[placement.PlacementSession] = None,
                 machine=None, device: DeviceLike = None) -> int:
    """Searched-vs-identity mapping comparison over each arch's sharding
    profiles on the multi-pod mesh (or ``--machine`` preset), one shared
    placement session for the whole sweep. Returns the failure count."""
    session = session or placement.PlacementSession(
        map_restarts=map_restarts, device=device)
    failures = 0
    for arch_name in arch_names:
        arch = configs.get(arch_name)
        for profile in arch.profiles:
            try:
                r = run_cell(arch_name, shape_name, multi_pod=True,
                             out_dir=out_dir, tag=f"map_{profile}",
                             profile=profile, overrides=overrides,
                             topology_aware=True, map_restarts=map_restarts,
                             recompile=recompile, session=session,
                             machine=machine)
                if r["status"] != "ok":
                    print(f"[SKIP] {arch_name}/{shape_name}/{profile}: "
                          f"{r.get('reason', '')[:60]}", flush=True)
                    continue
                rep = _report_of(r)
                print(rep.summary(), flush=True)
                if recompile:
                    print(rep.diff_summary(), flush=True)
            except Exception as e:
                failures += 1
                print(f"[FAIL] {arch_name}/{shape_name}/{profile}: {e}",
                      flush=True)
                traceback.print_exc()
    print(f"[CACHE] compiles={session.n_compiles} "
          f"hits={session.n_cache_hits} dir={session.cache_dir}",
          flush=True)
    return failures


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--machine", default=None,
                    help="machine-model preset (core.machine registry: "
                         + ", ".join(machine_lib.MachineSpec.presets())
                         + "); overrides --multi-pod/--single-pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--profile", default="2d",
                    help="lm sharding profile: 2d | fsdp | sp | expert")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--grad-compress-block", type=int, default=0,
                    help="per-block compression scale size (power of two; "
                         "implies --grad-compress; 0 = one scale per "
                         "tensor)")
    ap.add_argument("--topology-aware", action="store_true",
                    help="search the logical->physical device mapping over "
                         "the machine tree and report searched vs identity")
    ap.add_argument("--recompile", action="store_true",
                    help="retrace under the searched order and diff the "
                         "two collective schedules to a fixed point "
                         "(implies --topology-aware)")
    ap.add_argument("--map-restarts", type=int, default=32,
                    help="random-restart candidates appended to the "
                         "structured mapping search (0 disables)")
    ap.add_argument("--cache-dir", default=None,
                    help="trace cache directory (default "
                         "$REPRO_PLACEMENT_CACHE or "
                         "results/placement_cache_torch; '' disables)")
    ap.add_argument("--lint", action="store_true",
                    help="after the run, verify the kernel launch plans and "
                         "lint every traced traffic matrix "
                         "(repro_torch.analysis); error findings fail the "
                         "run")
    ap.add_argument("--mapping-grid", action="store_true",
                    help="multi-pod searched-vs-identity comparison for "
                         "every sharding profile of the given --arch "
                         "(default: qwen2-1.5b + deepseek-v2-lite-16b)")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (int), e.g. ep_shard_map=1")
    ap.add_argument("--device", default=None,
                    help="where the mapping searches run: the card unless "
                         "'cpu' (the plain PyTorch scorer)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    overrides = {}
    for kv in args.override:
        k, v = kv.split("=")
        overrides[k] = int(v)
    grad_compress = (args.grad_compress_block
                     or args.grad_compress)
    topology_aware = args.topology_aware or args.recompile
    session = placement.PlacementSession(cache_dir=args.cache_dir,
                                         map_restarts=args.map_restarts,
                                         device=device)

    machine = machine_lib.resolve(args.machine)

    if args.mapping_grid:
        archs = [args.arch] if args.arch else ["qwen2-1.5b",
                                               "deepseek-v2-lite-16b"]
        failures = mapping_grid(archs, args.shape or "train_4k", args.out,
                                overrides, map_restarts=args.map_restarts,
                                recompile=args.recompile, session=session,
                                machine=machine)
        if args.lint:
            _lint_gate(session)
        if failures:
            raise SystemExit(f"{failures} mapping-grid cells failed")
        return

    meshes = []
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    if args.multi_pod or args.all:
        meshes.append(True)
    if args.all:
        meshes = [False, True]
    if machine is not None:
        meshes = [False]          # the preset decides the mesh, not the flag

    cells: List[Tuple[str, str]] = []
    if args.all:
        for arch, shape in configs.all_cells():
            cells.append((arch.name, shape.name))
    else:
        arch = configs.get(args.arch)
        shapes = [args.shape] if args.shape else list(arch.shapes)
        cells = [(args.arch, s) for s in shapes]

    failures = 0
    for arch_name, shape_name in cells:
        for mp in meshes:
            mesh_tag = (machine.name if machine is not None
                        else ("2x16x16" if mp else "16x16"))
            try:
                r = run_cell(arch_name, shape_name, mp, args.out,
                             grad_compress=grad_compress, tag=args.tag,
                             profile=args.profile, overrides=overrides,
                             topology_aware=topology_aware,
                             map_restarts=args.map_restarts,
                             recompile=args.recompile, session=session,
                             machine=machine)
                if r["status"] == "skip":
                    print(f"[SKIP] {arch_name}/{shape_name}/{mesh_tag}: "
                          f"{r['reason'][:60]}", flush=True)
                else:
                    t = r["roofline_terms"]
                    hit = " (cache)" if r.get("cache_hit") else ""
                    print(f"[OK]   {arch_name}/{shape_name}/{mesh_tag} "
                          f"compile={r['compile_s']}s{hit} "
                          f"comp={t['compute_s']:.3e} "
                          f"mem={t['memory_s']:.3e} "
                          f"coll={t['collective_s']:.3e} "
                          f"dom={r['dominant']} "
                          f"roofline={r['roofline_fraction']:.2f}",
                          flush=True)
                    if "mapping" in r:
                        rep = _report_of(r)
                        print(rep.summary(), flush=True)
                        if args.recompile:
                            print(rep.diff_summary(), flush=True)
            except Exception as e:
                failures += 1
                print(f"[FAIL] {arch_name}/{shape_name}/{mesh_tag}: {e}",
                      flush=True)
                traceback.print_exc()
    print(f"[CACHE] compiles={session.n_compiles} "
          f"hits={session.n_cache_hits} dir={session.cache_dir}",
          flush=True)
    if args.lint:
        _lint_gate(session)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


def _lint_gate(session: placement.PlacementSession) -> None:
    """``--lint``: session-wide static analysis; errors fail the run. The
    registered kernel launch plans and the traffic lint of every traced
    matrix (``session.verify()``)."""
    from repro_torch import analysis
    findings = session.verify()
    print(analysis.format_findings(findings), flush=True)
    errors = analysis.at_least(findings, "error")
    if errors:
        raise SystemExit(f"--lint: {len(errors)} error-severity "
                         "finding(s)")


if __name__ == "__main__":
    main()
