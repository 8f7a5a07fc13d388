"""Training CLI of the port: twin of ``repro/launch/train.py`` for the LM,
recsys and GNN families (the message-passing GNNs and EquiformerV2).

    # on the card: Qwen2-1.5B at full width (train_4k's config), random
    # weights from seed 0
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 6 --batch 4 --seq 4096

    # on the card: two-tower retrieval at full width (1M x 256 item table)
    # with the sharded table's sparse rowwise Adagrad, the hot-row cache
    # report and the prefetching sampler
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch two-tower-retrieval --steps 6 --batch 32768 --embed-shard \\
        --embed-machine gpu-superpod --embed-cache-rows 65536 --prefetch 2

    # on a machine without a card: the reduced config through the plain
    # PyTorch path on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --device cpu --steps 3 [--ckpt-dir DIR] [--grad-compress]
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch two-tower-retrieval --smoke --device cpu --embed-shard \\
        --prefetch 2 [--fault-plan "3:leaf_death:1" --ckpt-dir DIR]
    PYTHONPATH=src python -m repro_torch.launch.train --arch pna \\
        --smoke --device cpu --steps 20     # or gin-tu, meshgraphnet,
                                            # equiformer-v2

``--smoke`` runs the reduced config; without it the full config is
``make_config`` of the grid's first shape (``train_4k`` for the LMs).
The GNN family (GIN-TU, PNA, MeshGraphNet and EquiformerV2, whose model
module is picked by the arch's name, ``models/equiformer.py``, as the
reference picks it) trains only with ``--smoke``, on
``arch.smoke_batch()`` every step, as the reference CLI does (GIN's batch
carries its BSR layouts, so it aggregates through ``bsr_spmm`` both
ways; EquiformerV2's carries ``pos``). Without ``--smoke`` the reference
CLI feeds that batch (``d_feat`` 8) to the first shape's config
(``full_graph_sm``: ``d_in`` 1,433) and crashes; this one refuses the
combination. A GNN trains at full width on the grid's own batches through
``train.steps.make_train_step`` and ``train.loop.run`` directly.
Weights are random, made from seed 0: the real checkpoints are not in the
repository. The batches are ``data.pipeline.lm_batches`` /
``recsys_batches`` (seed 0) and the optimizer is AdamW with the
reference's settings (``lr``, ``total_steps = steps``, ``warmup_steps =
min(20, steps // 10)``). The loop (``train.loop.run``) checkpoints every
``--ckpt-every`` steps under ``--ckpt-dir`` and resumes from the newest
checkpoint there. ``--grad-compress`` routes the gradients through the
int8 error-feedback round trip (``--grad-compress-block N``: one scale per
N-element block); the loop owns the residual.

``--embed-shard`` (recsys only) turns on ``repro_torch.embed``: probe
batches build the row co-access graph, the makespan partitioner shards the
item table over the ``--embed-machine`` model (a modelling choice; it
need not match the local device count), the table is permuted
device-contiguous and the loop steps with touched-rows-only rowwise
Adagrad (not with ``--grad-compress``). ``--embed-cache-rows N`` reports
the measured hot-row-cache traffic against the replicated baseline;
``--prefetch D`` builds the host batches on a producer thread ``D``
batches ahead.

``--fault-plan "3:leaf_death:1"`` (with ``--ckpt-dir``) injects a device
failure and runs under ``loop.run_supervised``: the machine model is
degraded, the newest checkpoint restored, the batch stream replayed from
its step, and the stitched loss trajectory is the uninterrupted one.

``--profile`` picks the LM sharding profile (2d | fsdp | sp | expert;
``launch.steps.rules_for``), whose rules the LM's loss takes; on plain
tensors they constrain nothing. ``--machine`` names the machine model
whose mesh the run is laid out on: a machine with more devices than
there are ranks raises the reference's error (``launch/mesh.py``).
``--lint`` runs the static analysis first, as the reference's does: the
kernel launch plans (``PlacementSession.verify()``) and this arch's
sharding specs and traced upcasts (``shard_lint.lint_cell`` at
``--profile``); an error finding aborts the run.

Several ranks: under ``torchrun`` (``WORLD_SIZE`` > 1) the run starts the
world's process group (``launch/mesh.init_world``: NCCL with one card a
rank, ``cuda:LOCAL_RANK``; gloo with ``--device cpu``) and lays itself out
on a ``DeviceMesh`` of it, the ``--machine`` model's or a 1-d ``data``
mesh over the ranks, as the reference lays its run out on the local
devices. The parameters, the AdamW moments and each batch are DTensors
placed by the profile's rules (``dist.sharding.distribute_tree``) and the
step is ``launch.steps.make_traced_train_step``, each gradient settled on
its parameter's placements. ``--topology-aware`` then traces the step on
the identity mesh, searches the logical -> physical order over the
machine model with ``--map-restarts`` restarts (:func:`searched_mesh`,
``PlacementSession.map_step``; rank 0's order on every rank) and trains
on the mapped mesh; with one rank it is a no-op, as the reference's is.
Under ``--fault-plan`` the supervisor keeps the launcher's mesh. Every
rank computes, checkpoints are written once (by rank 0) and the lines are
printed by rank 0. On several ranks the LM family runs under every
profile; the recsys and GNN families are refused (ROADMAP, the next
slice), and so are ``--grad-compress``, ``--embed-shard`` and
``--prefetch``.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2-1.5b --smoke --device cpu [--topology-aware]
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import configs, resolve_device, tree
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw
from repro_torch.train import loop
from repro_torch.train.steps import make_train_step

def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="LM, recsys and GNN (EquiformerV2 too) training on "
                    "the port.",
        epilog="Several ranks (torchrun): the LM family under every "
               "profile, --topology-aware included. Refused there: the "
               "recsys and GNN families, --grad-compress, --embed-shard "
               "and --prefetch (ROADMAP, the next slice).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--grad-compress-block", type=int, default=0,
                    help="per-block compression scale size (power of two; "
                         "implies --grad-compress; 0 = one scale per "
                         "tensor)")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="inject device failures: a JSON file or inline "
                         "'step:kind:target[:factor]' items, e.g. "
                         "'7:leaf_death:1'. Runs under the restart "
                         "supervisor: on a death the machine model is "
                         "degraded, the newest checkpoint restored and "
                         "training resumes on the replayed stream. Needs "
                         "--ckpt-dir for the loss trajectory's continuity")
    ap.add_argument("--max-restarts", type=int, default=4,
                    help="supervisor restart budget before the injected "
                         "failure propagates")
    ap.add_argument("--embed-shard", action="store_true",
                    help="recsys only: partition the item table by the "
                         "measured row co-access graph, permute it "
                         "device-contiguous, and train with "
                         "touched-rows-only sparse table updates")
    ap.add_argument("--embed-cache-rows", type=int, default=0,
                    help="with --embed-shard: hot-row cache slots for the "
                         "lookup-traffic report (0 = no cache)")
    ap.add_argument("--embed-probe-batches", type=int, default=4,
                    help="batches probed to build the co-access graph")
    ap.add_argument("--embed-machine", default=None,
                    help="machine model the table is sharded against "
                         "(default: the local device count); a modelling "
                         "choice, its mesh need not fit the local devices")
    ap.add_argument("--prefetch", type=int, default=0, metavar="DEPTH",
                    help="async batch prefetch depth (0 = off; 2 = "
                         "double buffering)")
    ap.add_argument("--profile", default="2d",
                    help="LM sharding profile: 2d | fsdp | sp | expert")
    ap.add_argument("--topology-aware", action="store_true",
                    help="search the logical -> physical device order of "
                         "the mesh (a no-op on one rank)")
    ap.add_argument("--map-restarts", type=int, default=32,
                    help="random restarts appended to the mapping search")
    ap.add_argument("--machine", default=None,
                    help="machine-model preset (core.machine registry) "
                         "whose mesh the run is laid out on")
    ap.add_argument("--lint", action="store_true",
                    help="verify the kernel launch plans and lint this "
                         "arch's sharding at --profile first; error "
                         "findings abort")
    return ap


def optimizer_config(lr: float, steps: int) -> adamw.AdamWConfig:
    """The CLI's AdamW settings for a run of ``steps`` steps."""
    return adamw.AdamWConfig(lr=lr, total_steps=steps,
                             warmup_steps=min(20, steps // 10))


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_batches(vocab: int, batch: int, seq: int, device: torch.device,
                 seed: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    """``lm_batches`` as tensors on ``device``."""
    for b in pipeline.lm_batches(vocab, batch, seq, seed=seed):
        yield to_device(b, device)


def host_batches(family: str, cfg, batch: int, seq: int, seed: int = 0,
                 arch=None) -> Iterator[Dict[str, np.ndarray]]:
    """The family's batch stream as host arrays: ``lm_batches`` or
    ``recsys_batches`` from ``seed``; for a GNN, ``arch.smoke_batch()``
    every step, as the reference CLI feeds it."""
    if family == "lm":
        return pipeline.lm_batches(cfg.vocab, batch, seq, seed=seed)
    if family == "gnn":
        return itertools.repeat(arch.smoke_batch())
    return pipeline.recsys_batches(cfg.n_items, cfg.n_cats, batch,
                                   cfg.hist_len, cfg.d_dense, seed=seed)


def probe_embed_stats(cfg, n_rows: int, batch: int, n_batches: int):
    """Replay the training stream's first batches (same seed) into a row
    co-access measurement for the table partitioner."""
    from repro_torch import embed
    stats = embed.RowAccessStats(n_rows)
    gen = pipeline.recsys_batches(cfg.n_items, cfg.n_cats, batch,
                                  cfg.hist_len, cfg.d_dense)
    for b in itertools.islice(gen, n_batches):
        stats.record(b["user_hist"])
        stats.record(b["item_id"])
    return stats


def embed_traffic_report(stats, plan, table, cfg, batch: int,
                         cache_rows: int, n_batches: int):
    """Drive the hot-row cache over the probe stream; returns the cache
    (measured [D, D] traffic inside) and the replicated baseline matrix."""
    from repro_torch import embed
    st = embed.ShardedEmbeddingTable(table, plan, permuted=True)
    cache = embed.HotRowCache(st, n_cache=cache_rows, policy="lru")
    if cache_rows:
        cache.warm(stats.top_rows(cache_rows))
    rep = np.zeros((plan.n_devices, plan.n_devices))
    gen = pipeline.recsys_batches(cfg.n_items, cfg.n_cats, batch,
                                  cfg.hist_len, cfg.d_dense)
    for b in itertools.islice(gen, n_batches):
        hist = np.asarray(b["user_hist"])
        req_row = embed.requester_of(hist.shape[0], plan.n_devices)
        valid = hist >= 0
        ids = hist[valid]
        req = np.broadcast_to(req_row[:, None], hist.shape)[valid]
        cache.lookup(ids, req)
        rep += embed.replicated_update_traffic(ids, req, plan.n_devices,
                                               st.row_bytes)
    cache.check_invariants()
    return cache, rep


def layout(args, family: str, n_dev: int):
    """(machine, mesh axes, rules) of a run on ``n_dev`` ranks: the
    ``--machine`` model's mesh (refused, with the reference's error, when
    it has more devices than there are), else a 1-d ``data`` mesh; the
    rules of ``--profile`` on its axes. ``--lint`` runs its gate here,
    before anything is built (:func:`_lint_gate`)."""
    from repro_torch.core import machine as machine_lib
    from repro_torch.launch.steps import rules_for
    if args.lint:
        _lint_gate(args.arch, args.profile)
    machine = machine_lib.resolve(args.machine)
    if machine is not None:
        shape, axes = machine.mesh_spec()
        n = int(np.prod(shape))
        if n_dev < n:
            raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, "
                             f"got {n_dev}")
    else:
        axes = ("data",)
    return machine, axes, rules_for(family, axes, profile=args.profile)


def _lint_gate(arch_name: str, profile: str) -> None:
    """``--lint``: the kernel registry (``PlacementSession.verify()``) and
    this cell's sharding specs and traced upcasts
    (``shard_lint.lint_cell``); error findings abort."""
    from repro_torch import analysis
    from repro_torch.analysis import shard_lint
    from repro_torch.launch.placement import PlacementSession
    findings = PlacementSession(cache_dir="", device="cpu").verify()
    findings.extend(shard_lint.lint_cell(arch_name, profile=profile))
    mesh_lib.say(analysis.format_findings(findings))
    errors = analysis.at_least(findings, "error")
    if errors:
        raise SystemExit(f"--lint: {len(errors)} error-severity "
                         "finding(s)")


def searched_mesh(step, step_args, mesh, scan_lengths, map_restarts=32,
                  session=None, machine=None):
    """Thin wrapper over ``PlacementSession.map_step``: trace ``step`` once
    on ``mesh``, search the logical -> physical order over the machine
    model (``machine``, else the tree guessed from the mesh shape) and
    return (mapped mesh, PlacementReport)."""
    from repro_torch.launch.placement import PlacementSession
    session = session or PlacementSession(map_restarts=map_restarts)
    return session.map_step(step, step_args, mesh, scan_lengths,
                            tag="train-step", machine=machine)


def _refuse_on_ranks(args, family: str) -> None:
    """What a process group's mesh does not run yet: raises SystemExit
    naming ROADMAP."""
    why = None
    if family != "lm":
        why = f"the {family} family"
    elif args.grad_compress or args.grad_compress_block:
        why = "--grad-compress"
    elif args.embed_shard:
        why = "--embed-shard"
    elif args.prefetch:
        why = "--prefetch"
    if why:
        raise SystemExit(f"{why} on a process group's mesh is not ported "
                         f"(ROADMAP, Queue 1: the other families on several "
                         f"ranks); run it on one device")


@dataclasses.dataclass
class TrainSetup:
    """What :func:`build` makes of the arguments: the model, its
    optimizer state, the step, the loop config and a replayable batch
    stream (``batches(start)``: from step ``start``, on the device,
    prefetched when asked); ``embed`` holds the shard plan, ``row_perm``,
    the hot-row cache and its baseline, and their seconds. On a process
    group ``mesh`` is the (mapped) mesh the run is laid out on,
    ``state_specs`` the spec tree of ``(params, opt)`` a resume places
    them by, and ``mapping`` the ``--topology-aware`` report."""
    arch: Any
    cfg: Any
    device: torch.device
    params: Any
    opt: Any
    step: Callable
    lcfg: loop.LoopConfig
    batches: Callable[[int], Iterator]
    loss_fn: Callable
    embed: Optional[Dict[str, Any]] = None
    rules: Any = None
    mesh: Any = None
    machine: Any = None
    state_specs: Any = None
    mapping: Any = None


def build(args) -> TrainSetup:
    """Build the model, optimizer, step, loop config and batch stream from
    parsed arguments (printing what the reference CLI prints). Under
    ``torchrun`` it starts the world's process group and lays the run out
    on its mesh (see the module docstring)."""
    import torch.distributed as dist
    arch = configs.get(args.arch)
    cfg = arch.smoke_config() if args.smoke else arch.make_config(
        next(iter(arch.shapes)))
    if arch.family == "gnn" and not args.smoke:
        first = next(iter(arch.shapes))
        raise SystemExit(
            f"--arch {arch.name} trains with --smoke only: the reference "
            f"CLI feeds every GNN step arch.smoke_batch() (d_feat "
            f"{arch.smoke_config().d_in}) while its config is "
            f"make_config({first!r}) (d_in {cfg.d_in}), and crashes "
            f"(src/repro/launch/train.py:57-70). Train a GNN at full width "
            f"on the grid's batches through train.steps.make_train_step "
            f"and train.loop.run")
    dev = mesh_lib.init_world(resolve_device(args.device))
    on_mesh = dist.is_initialized()
    if on_mesh:
        _refuse_on_ranks(args, arch.family)
    n_dev = mesh_lib.world_size()
    machine, axes, rules = layout(args, arch.family, n_dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if arch.family == "lm":
        from repro_torch.models import transformer as mdl
    elif arch.family == "recsys":
        from repro_torch.models import recsys as mdl
    elif arch.name == "equiformer-v2":
        from repro_torch.models import equiformer as mdl
    else:
        from repro_torch.models import gnn as mdl
    params = mdl.init(cfg, gen, device=dev)
    n_params = sum(int(np.prod(x.shape)) for x in tree.leaves(params))
    mesh_lib.say(f"arch={arch.name} params={n_params / 1e6:.1f}M "
         f"devices={n_dev} ({dev})")
    grad_compress = args.grad_compress_block or args.grad_compress
    ocfg = optimizer_config(args.lr, args.steps)
    ecfg = False
    embed_info = None
    if args.embed_shard:
        if arch.family != "recsys":
            raise SystemExit("--embed-shard requires a recsys arch")
        if grad_compress:
            raise SystemExit("--embed-shard and --grad-compress are "
                             "mutually exclusive")
        from repro_torch import embed
        from repro_torch.core import machine as machine_lib
        from repro_torch.embed import training as embed_training
        t0 = time.perf_counter()
        stats = probe_embed_stats(cfg, params["item_table"].shape[0],
                                  args.batch, args.embed_probe_batches)
        probe_s = time.perf_counter() - t0
        emachine = machine_lib.resolve(args.embed_machine)
        t0 = time.perf_counter()
        plan = embed.plan_shards(
            stats, machine=emachine,
            n_devices=None if emachine is not None else 1, device=dev)
        plan.check()
        plan_s = time.perf_counter() - t0
        params["item_table"] = params["item_table"][
            torch.as_tensor(plan.order, device=dev)]
        row_perm = torch.as_tensor(plan.perm, device=dev)
        ecfg = embed_training.EmbedConfig()
        opt = embed_training.init_dense_opt(params, ecfg, ocfg)

        def loss_fn(p, b):
            return mdl.loss_fn(p, b, cfg, row_perm)
        step = embed_training.make_embed_train_step(loss_fn, ocfg, ecfg)
        sizes = plan.shard_sizes
        print(f"embed: {plan.n_rows} rows over {plan.n_devices} leaves of "
              f"{plan.machine or 'local'} (rows/leaf "
              f"{int(sizes.min())}..{int(sizes.max())}, makespan "
              f"{plan.makespan:.3e})", flush=True)
        t0 = time.perf_counter()
        cache, rep = embed_traffic_report(
            stats, plan, params["item_table"], cfg, args.batch,
            args.embed_cache_rows, args.embed_probe_batches)
        cache_s = time.perf_counter() - t0
        print(f"embed traffic: replicated {rep.sum() / 2:.0f} B -> "
              f"sharded+cache({args.embed_cache_rows}) "
              f"{cache.traffic_bytes():.0f} B "
              f"(hit rate {cache.hit_rate:.2f})", flush=True)
        embed_info = dict(stats=stats, plan=plan, row_perm=row_perm,
                          ecfg=ecfg, cache=cache, replicated=rep,
                          probe_s=probe_s, plan_s=plan_s, cache_s=cache_s)
    else:
        def loss_fn(p, b):
            if arch.family == "lm":
                return mdl.loss_fn(p, b, cfg, rules=rules)
            return mdl.loss_fn(p, b, cfg)
        if not on_mesh:
            opt = adamw.init(params, ocfg)
            step = make_train_step(loss_fn, ocfg,
                                   grad_compress=grad_compress)
    lcfg = loop.LoopConfig(total_steps=args.steps,
                           ckpt_every=args.ckpt_every,
                           ckpt_dir=args.ckpt_dir,
                           grad_compress=grad_compress,
                           embed_sparse=ecfg)
    mesh = state_specs = mapping = None
    if on_mesh:
        mesh, params, opt, step, state_specs, mapping = _lay_out(
            args, cfg, mdl, rules, machine, params, ocfg, loss_fn, dev)

    def on_device(b):
        out = to_device(b, dev)
        if arch.family == "gnn" and getattr(cfg, "kind", None) == "gin":
            from repro_torch.models.gnn import gin_layouts
            out.update(gin_layouts(b, device=dev))
        if mesh is not None:
            out = _place_batch(out, rules, mesh)
        return out

    def batches(start: int = 0) -> Iterator:
        host = itertools.islice(
            host_batches(arch.family, cfg, args.batch, args.seq, arch=arch),
            start, None)
        if args.prefetch:
            from repro_torch.embed import PrefetchIterator
            return PrefetchIterator(host, depth=args.prefetch,
                                    consume=on_device)
        return (on_device(b) for b in host)

    return TrainSetup(arch=arch, cfg=cfg, device=dev, params=params,
                      opt=opt, step=step, lcfg=lcfg, batches=batches,
                      loss_fn=loss_fn, embed=embed_info, rules=rules,
                      mesh=mesh, machine=machine, state_specs=state_specs,
                      mapping=mapping)


def _place_batch(batch, rules, mesh):
    """An LM batch as DTensors on ``mesh``, sharded on the ``batch`` axis:
    every rank holds the same host batch (the stream is seeded), so each
    keeps its own shard and nothing moves."""
    from repro_torch.dist import sharding
    return sharding.distribute_tree(
        batch, {k: rules.spec("batch", None) for k in batch}, mesh,
        src_data_rank=None)


def _lay_out(args, cfg, mdl, rules, machine, params, ocfg, loss_fn, dev):
    """The run on the process group's mesh: (mesh, params, opt, step,
    state specs, mapping report or None). The ``--machine`` model's mesh
    or a 1-d ``data`` mesh over the ranks; the parameters placed by
    ``mdl.param_specs`` under the rules, the AdamW moments like them
    (``adamw.state_specs``); with ``--topology-aware`` on several ranks the
    step is traced on the identity mesh, mapped (:func:`searched_mesh`)
    and the state placed again on the mapped mesh."""
    import logging

    from repro_torch.dist import sharding
    from repro_torch.launch.placement import PlacementSession
    from repro_torch.launch.steps import make_traced_train_step
    # DTensor warns at each sequential multi-axis redistribution
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    session = PlacementSession(cache_dir="", map_restarts=args.map_restarts,
                               device=dev)
    mesh = (mesh_lib.make_machine_mesh(machine) if machine is not None
            else session.local_mesh())
    if mesh.size() != mesh_lib.world_size():
        raise SystemExit(f"--machine {machine.name}: a mesh of "
                         f"{mesh.size()} devices on a world of "
                         f"{mesh_lib.world_size()} ranks")
    pspec = mdl.param_specs(cfg, rules)
    state_specs = (pspec, adamw.state_specs(pspec))
    step = make_traced_train_step(loss_fn, ocfg)

    def place(m):
        p = sharding.distribute_tree(params, pspec, m)
        return p, adamw.init(p, ocfg)
    placed, opt = place(mesh)
    rep = None
    if args.topology_aware and mesh.size() > 1:
        host = pipeline.lm_batches(cfg.vocab, args.batch, args.seq)
        probe = (placed, opt, _place_batch(to_device(next(host), dev),
                                           rules, mesh))
        mesh, rep = searched_mesh(step, probe, mesh, [cfg.n_layers],
                                  session=session, machine=machine)
        mesh_lib.say(f"topology-aware mapping: identity makespan "
             f"{rep.identity['makespan']:.3e} -> searched "
             f"{rep.searched['makespan']:.3e} ({rep.n_candidates} "
             f"candidates)")
        placed, opt = place(mesh)
    return mesh, placed, opt, step, state_specs, rep


def train(args) -> tuple:
    """Build from parsed arguments and run: ``loop.run``, or
    ``loop.run_supervised`` under ``--fault-plan`` (on a process group
    keeping the launcher's mesh, as the reference does). Returns (params,
    opt_state, LoopResult or SupervisedResult, the batch stream of the
    last attempt)."""
    s = build(args)
    if args.fault_plan:
        from repro_torch.resilience.faults import parse_fault_plan
        streams = []

        def factory(start):
            streams.append(s.batches(start))
            return streams[-1]
        mesh_fn = None if s.mesh is None else (lambda n_alive: s.mesh)
        params, opt, sup = loop.run_supervised(
            s.step, s.params, s.opt, factory, s.lcfg,
            parse_fault_plan(args.fault_plan), machine=s.machine,
            mesh_fn=mesh_fn, state_specs=s.state_specs or True,
            max_restarts=args.max_restarts)
        return params, opt, sup, streams[-1]
    stream = s.batches(0)
    params, opt, result = loop.run(s.step, s.params, s.opt, stream, s.lcfg,
                                   mesh=s.mesh, state_specs=s.state_specs)
    return params, opt, result, stream


def main(argv=None) -> None:
    import torch.distributed as dist
    args = _parser().parse_args(argv)
    try:
        _report(args, *train(args)[2:])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _report(args, result, stream) -> None:
    """The run's closing lines, the reference's (from rank 0)."""
    if args.fault_plan:
        for rec in result.recoveries:
            mesh_lib.say(f"[TRAIN] recovery: device {rec['device']} died at step "
                 f"{rec['step']}; resumed from checkpoint "
                 f"{rec['resumed_from']} on {rec['n_alive']} leaves")
        mesh_lib.say(f"steps={result.steps_run} attempts={result.attempts} "
             f"recoveries={len(result.recoveries)} "
             f"loss {result.losses[0]:.4f} -> {result.losses[-1]:.4f}")
    else:
        mesh_lib.say(f"steps={result.steps_run} resumed_from={result.resumed_from} "
             f"loss {result.losses[0]:.4f} -> {result.losses[-1]:.4f} "
             f"({result.seconds:.1f}s, "
             f"stragglers={result.straggler_steps})")
    if getattr(stream, "is_prefetcher", False):
        st = stream.stats()
        print(f"prefetch: depth={st['depth']} produced={st['produced']} "
              f"ready_hits={st['ready_hits']} "
              f"max_occupancy={st['max_occupancy']}", flush=True)


if __name__ == "__main__":
    main()
