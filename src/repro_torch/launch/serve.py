"""Serving CLI of the port: continuous-batching stream serving (default)
or the one-shot batched decode. Twin of ``repro/launch/serve.py``.

    # stream: N mixed-length requests through the continuous-batching
    # engine with the placement-aware paged KV cache (on the card)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        [--smoke] [--num-requests 16 --seed 0] [--trace serve_trace.json] \\
        [--replace-every 16 --place-devices 4] [--machine tpu-mixed-32] \\
        [--fault-plan "6:leaf_death:1"]

    # one-shot: the fixed-batch decode path (prefill by stepping the cache);
    # the only mode for MLA (deepseek-v2-*), whose rank-compressed cache
    # the paged stream does not serve (the stream raises, as the
    # reference's does)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --smoke --oneshot --batch 4 --prompt-len 16 --gen-len 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-lite-16b --oneshot

    # on a machine without a card: the plain PyTorch path on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --smoke --device cpu

Weights are random, made from seed 0 (``models.transformer.init``); the
full config is ``make_config("decode_32k")``. ``--fault-plan`` injects
faults into the stream (``resilience.parse_fault_plan``): a leaf death
drops its pages, requeues their requests and re-places the survivors, and
every completed request's tokens stay the clean run's. ``--profile``
picks the LM sharding profile on the serving mesh's axes
(``launch.mesh.serving_mesh_spec``; the one-shot decode takes its rules,
which constrain nothing on plain tensors); ``--map-restarts`` sets the
placement session's mapping restarts.

Several ranks: under ``torchrun`` the one-shot decode starts the world's
process group (``launch/mesh.init_world``: NCCL with one card a rank,
gloo with ``--device cpu``) and runs on a ``DeviceMesh`` of it, the
``--machine`` model's or the serving mesh over the ranks, as the
reference's runs under its mesh: the parameters and the cache are
DTensors placed by the serving rules, every rank decodes and samples the
same tokens, and rank 0 prints. ``--topology-aware`` then maps the decode
step (``PlacementSession.map_step``, traced on the identity mesh) and
decodes on the mapped mesh with the parameters and a fresh cache placed
there; with one rank it is a no-op, as the reference's is. The stream
server is refused on a process group (ROADMAP, the next slice).

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch qwen2-1.5b --smoke --device cpu --oneshot --topology-aware
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.dist.sharding import NO_MESH
from repro_torch.launch import mesh as mesh_lib


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Stream or one-shot LM serving on the port.",
        epilog="Several ranks (torchrun): the one-shot decode, "
               "--topology-aware included (a no-op on one rank). Refused "
               "there: the stream server (ROADMAP, the next slice).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--profile", default="2d",
                    help="lm sharding profile: 2d | fsdp | sp | expert")
    ap.add_argument("--map-restarts", type=int, default=32)
    ap.add_argument("--topology-aware", action="store_true",
                    help="one-shot path: search the decode mesh's device "
                         "order (a no-op on one rank)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for sampling (and the stream workload) — "
                         "decode output is deterministic given a seed")
    ap.add_argument("--temperature", type=float, default=0.8,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--machine", default=None,
                    help="machine-model preset (core.machine registry)")
    # -- mode selection --
    ap.add_argument("--oneshot", action="store_true",
                    help="fixed-batch decode instead of the "
                         "continuous-batching stream loop")
    ap.add_argument("--stream", action="store_true",
                    help="continuous-batching stream serving (default)")
    # -- one-shot knobs --
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    # -- stream knobs --
    ap.add_argument("--num-requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4,
                    help="max concurrent streams")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--n-pages", type=int, default=0,
                    help="KV pool pages (0 = sized from slots and "
                         "lengths)")
    ap.add_argument("--replace-every", type=int, default=16,
                    help="decode steps per page-placement epoch (0 = "
                         "placement off)")
    ap.add_argument("--drift-threshold", type=float, default=0.1)
    ap.add_argument("--place-devices", type=int, default=0,
                    help="placement bins (0 = machine/device count)")
    ap.add_argument("--static-batching", action="store_true",
                    help="admit only into an idle batch (the baseline "
                         "the bench compares against)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the ServeReport JSON (per-request "
                         "lifecycle + placement epochs)")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="inject faults into the stream loop: a JSON "
                         "file ({\"events\": [...]}) or inline "
                         "'step:kind:target[:factor]' items, comma-"
                         "separated, e.g. '6:leaf_death:1'. Survivor "
                         "outputs stay identical to a clean run's")
    return ap


def _setup(args):
    """(cfg, device, params) of the arguments, with ``args.rules`` (the
    profile's rules on the serving mesh's axes) and ``args.mesh``: under
    ``torchrun`` the world's process group is started and ``args.mesh`` is
    its mesh (the ``--machine`` model's or the serving mesh), the
    parameters DTensors placed on it; without a group ``args.mesh`` is
    None and the parameters are plain."""
    import torch.distributed as dist
    arch = configs.get(args.arch)
    if arch.family != "lm":
        raise SystemExit("serve.py drives LM decode")
    cfg = arch.smoke_config() if args.smoke else arch.make_config(
        "decode_32k")
    from repro_torch.core import machine as machine_lib
    from repro_torch.dist import sharding
    from repro_torch.launch.steps import rules_for
    dev = mesh_lib.init_world(resolve_device(args.device))
    args.mesh = None
    if dist.is_initialized():
        machine = machine_lib.resolve(args.machine)
        args.mesh = (mesh_lib.make_machine_mesh(machine) if machine
                     else mesh_lib.make_mapped_mesh(
                         *mesh_lib.serving_mesh_spec()))
        if args.mesh.size() != mesh_lib.world_size():
            raise SystemExit(f"--machine {machine.name}: a mesh of "
                             f"{args.mesh.size()} devices on a world of "
                             f"{mesh_lib.world_size()} ranks")
        axes = args.mesh.mesh_dim_names
    else:
        _, axes = mesh_lib.serving_mesh_spec()
    args.rules = rules_for("lm", axes, profile=args.profile)
    from repro_torch.models import transformer as tr
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = tr.init(cfg, gen, device=dev)
    if args.mesh is not None:
        params = sharding.distribute_tree(
            params, tr.param_specs(cfg, args.rules), args.mesh)
    return cfg, dev, params


def stream_workload(vocab: int, num_requests: int, prompt_len: int,
                    gen_len: int, slots: int, page_size: int, n_pages: int,
                    seed: int):
    """The CLI's request stream: prompts of 2..max(prompt_len, 2) tokens
    and 1..max(gen_len, 2) new tokens from ``seed``, and the pool sizing
    (pages per request from the longest, ``n_pages`` = that x
    max(slots, 2) x 2 unless given). Returns (prompts, gens, max_pages,
    n_pages)."""
    rng = np.random.default_rng(seed)
    max_prompt = max(prompt_len, 2)
    max_gen = max(gen_len, 2)
    # mixed prompt/gen lengths — the workload continuous batching exists
    # for
    prompts = [rng.integers(0, vocab, int(rng.integers(2, max_prompt + 1)),
                            dtype=np.int64).astype(np.int32)
               for _ in range(num_requests)]
    gens = [int(rng.integers(1, max_gen + 1)) for _ in range(num_requests)]
    longest = max(p.shape[0] + g for p, g in zip(prompts, gens))
    max_pages = -(-longest // page_size)
    n_pages = n_pages or max_pages * max(slots, 2) * 2
    return prompts, gens, max_pages, n_pages


def serve_stream(args) -> None:
    from repro_torch.launch.placement import PlacementSession
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg, dev, params = _setup(args)
    if args.mesh is not None:
        raise SystemExit("the stream server on a process group's mesh is "
                         "not ported (ROADMAP, Queue 1: the next slice); "
                         "use --oneshot, or one process")
    prompts, gens, max_pages, n_pages = stream_workload(
        cfg.vocab, args.num_requests, args.prompt_len, args.gen_len,
        args.slots, args.page_size, args.n_pages, args.seed)
    ecfg = EngineConfig(
        n_slots=args.slots, page_size=args.page_size, n_pages=n_pages,
        max_pages_per_req=max_pages, temperature=args.temperature,
        seed=args.seed, static_batching=args.static_batching,
        replace_every=args.replace_every,
        drift_threshold=args.drift_threshold,
        place_devices=args.place_devices, machine=args.machine)
    injector = None
    if args.fault_plan:
        from repro_torch.resilience.faults import (FaultInjector,
                                                   parse_fault_plan)
        injector = FaultInjector(parse_fault_plan(args.fault_plan))
    session = PlacementSession(machine=args.machine, device=dev,
                               map_restarts=args.map_restarts)
    engine = ServingEngine(params, cfg, ecfg, session=session,
                           injector=injector, device=dev)
    for p, g in zip(prompts, gens):
        engine.submit(p, g)
    report = engine.run()
    print(report.summary(), flush=True)
    for ev in report.placements:
        print(f"[SERVE]   placement step={ev['step']} "
              f"devices={ev['n_devices']} makespan={ev['makespan']:.3e} "
              f"drift={ev['drift_ratio']} replaced={ev['replaced']} "
              f"moved={ev['pages_moved']}", flush=True)
    for rec in report.recoveries:
        print(f"[SERVE]   recovery step={rec['step']} "
              f"device={rec['device']} pages_lost={rec['pages_lost']} "
              f"requeued={rec['requests_requeued']} "
              f"failed={rec['requests_failed']} n_alive={rec['n_alive']}",
              flush=True)
    if args.trace:
        with open(args.trace, "w") as f:
            f.write(report.to_json())
        print(f"[SERVE] wrote trace to {args.trace}", flush=True)


def _on_mesh(t: torch.Tensor, rules, mesh) -> torch.Tensor:
    """Tokens ``t [B, 1]`` as a DTensor on ``mesh`` sharded on the
    ``batch`` axis; every rank holds the same tokens, so each keeps its
    own shard and nothing moves. Plain ``t`` without a mesh."""
    if mesh is None:
        return t
    from repro_torch.dist import sharding
    return sharding.distribute_tree(t, rules.spec("batch", None), mesh,
                                    src_data_rank=None)


def _cache(cfg, batch: int, max_seq: int, dev, rules, mesh):
    """A zero decode cache, placed by ``cache_specs`` on ``mesh`` when
    there is one."""
    from repro_torch.dist import sharding
    from repro_torch.models import transformer as tr
    cache = tr.init_cache(cfg, batch, max_seq, device=dev)
    if mesh is None:
        return cache
    return sharding.distribute_tree(cache, tr.cache_specs(cfg, rules), mesh)


def oneshot(params, cfg, dev, batch: int, prompt_len: int, gen_len: int,
            temperature: float, seed: int, rules=NO_MESH, mesh=None):
    """The fixed-batch decode: ``batch`` random prompts of ``prompt_len``
    tokens from ``seed``, prefilled by stepping the decode cache (simple,
    exact), then ``gen_len`` sampled tokens (greedy at temperature 0).
    With ``mesh`` (``params`` DTensors on it) the cache and each step's
    tokens are placed on it too, and every rank samples the same tokens
    from the whole logits. Returns (generated tokens [batch, gen_len] as
    numpy, wall seconds of the decode loop, decode steps)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import transformer as tr
    max_seq = prompt_len + gen_len
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                         device=dev)
    cache = _cache(cfg, batch, max_seq, dev, rules, mesh)
    t0 = time.time()
    out = []
    tok = toks[:, :1]
    # the rope tables and the mask meet DTensors as replicated
    with implicit_replication():
        for pos in range(max_seq - 1):
            logits, cache = tr.decode_step(params, cache,
                                           _on_mesh(tok, rules, mesh), pos,
                                           cfg, rules)
            if mesh is not None:
                logits = logits.full_tensor()
            if pos + 1 < prompt_len:
                tok = toks[:, pos + 1: pos + 2]
            else:
                if temperature <= 0:
                    nxt = torch.argmax(logits, dim=-1)
                else:
                    probs = torch.softmax(logits.float() / temperature, -1)
                    nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
                tok = nxt[:, None]
                out.append(tok.cpu().numpy())
    return np.concatenate(out, axis=1), time.time() - t0, max_seq - 1


def map_decode(params, cfg, dev, batch: int, max_seq: int, rules, mesh,
               session, machine=None):
    """``--topology-aware`` for the one-shot decode: the decode step traced
    on ``mesh`` (identity order) with a zero cache and tokens placed
    there, mapped by ``session.map_step`` over ``machine`` (else the tree
    guessed from the mesh), as the reference's ``serve_oneshot`` does.
    Returns (mapped mesh, the parameters placed on it, the report)."""
    from repro_torch import tree
    from repro_torch.dist import sharding
    from repro_torch.models import transformer as tr

    def decode_fn(p, c, t, pos):
        return tr.decode_step(p, c, t, pos, cfg, rules)
    probe = (params, _cache(cfg, batch, max_seq, dev, rules, mesh),
             _on_mesh(torch.zeros((batch, 1), dtype=torch.int64,
                                  device=dev), rules, mesh), 0)
    mapped, rep = session.map_step(decode_fn, probe, mesh, [cfg.n_layers],
                                   tag="decode-step", machine=machine)
    whole = tree.map_(lambda t: t.full_tensor(), params)
    return mapped, sharding.distribute_tree(
        whole, tr.param_specs(cfg, rules), mapped), rep


def serve_oneshot(args) -> None:
    cfg, dev, params = _setup(args)
    mesh = args.mesh
    if args.topology_aware and mesh is not None and mesh.size() > 1:
        from repro_torch.launch.placement import PlacementSession
        session = PlacementSession(cache_dir="",
                                   map_restarts=args.map_restarts,
                                   device=dev)
        mesh, params, rep = map_decode(
            params, cfg, dev, args.batch, args.prompt_len + args.gen_len,
            args.rules, mesh, session, args.machine)
        mesh_lib.say(rep.summary())
    gen_toks, dt, _ = oneshot(params, cfg, dev, args.batch, args.prompt_len,
                              args.gen_len, args.temperature, args.seed,
                              args.rules, mesh)
    tput = args.batch * gen_toks.shape[1] / dt
    mesh_lib.say(f"generated {gen_toks.shape} tokens in {dt:.2f}s "
         f"({tput:.1f} tok/s); sample row: {gen_toks[0][:16].tolist()}")


def main() -> None:
    import torch.distributed as dist
    args = _parser().parse_args()
    if args.oneshot and args.stream:
        raise SystemExit("--oneshot and --stream are exclusive")
    try:
        if args.oneshot:
            serve_oneshot(args)
        else:
            serve_stream(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
