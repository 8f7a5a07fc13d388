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
every completed request's tokens stay the clean run's. The reference's
``--profile``, ``--topology-aware`` and ``--map-restarts`` belong to its
mesh search and are not ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Stream or one-shot LM serving on the port.",
        epilog="Not ported from the reference CLI: --profile and "
               "--topology-aware (mesh search) and --map-restarts (mesh "
               "search restarts).")
    ap.add_argument("--arch", required=True)
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
    arch = configs.get(args.arch)
    if arch.family != "lm":
        raise SystemExit("serve.py drives LM decode")
    cfg = arch.smoke_config() if args.smoke else arch.make_config(
        "decode_32k")
    dev = resolve_device(args.device)
    from repro_torch.models import transformer as tr
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return cfg, dev, tr.init(cfg, gen, device=dev)


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
    session = PlacementSession(machine=args.machine, device=dev)
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


def oneshot(params, cfg, dev, batch: int, prompt_len: int, gen_len: int,
            temperature: float, seed: int):
    """The fixed-batch decode: ``batch`` random prompts of ``prompt_len``
    tokens from ``seed``, prefilled by stepping the decode cache (simple,
    exact), then ``gen_len`` sampled tokens (greedy at temperature 0).
    Returns (generated tokens [batch, gen_len] as numpy, wall seconds
    of the decode loop, decode steps)."""
    from repro_torch.models import transformer as tr
    max_seq = prompt_len + gen_len
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                         device=dev)
    cache = tr.init_cache(cfg, batch, max_seq, device=dev)
    t0 = time.time()
    out = []
    tok = toks[:, :1]
    for pos in range(max_seq - 1):
        logits, cache = tr.decode_step(params, cache, tok, pos, cfg)
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


def serve_oneshot(args) -> None:
    cfg, dev, params = _setup(args)
    gen_toks, dt, _ = oneshot(params, cfg, dev, args.batch, args.prompt_len,
                              args.gen_len, args.temperature, args.seed)
    tput = args.batch * gen_toks.shape[1] / dt
    print(f"generated {gen_toks.shape} tokens in {dt:.2f}s "
          f"({tput:.1f} tok/s); sample row: {gen_toks[0][:16].tolist()}")


def main() -> None:
    args = _parser().parse_args()
    if args.oneshot and args.stream:
        raise SystemExit("--oneshot and --stream are exclusive")
    if args.oneshot:
        serve_oneshot(args)
    else:
        serve_stream(args)


if __name__ == "__main__":
    main()
