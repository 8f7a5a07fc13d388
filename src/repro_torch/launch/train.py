"""Training CLI of the port: twin of ``repro/launch/train.py`` for the LM
family.

    # on the card: Qwen2-1.5B at full width (train_4k's config), random
    # weights from seed 0
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 6 --batch 4 --seq 4096

    # on a machine without a card: the reduced config through the plain
    # PyTorch path on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --device cpu --steps 3 [--ckpt-dir DIR] [--grad-compress]

``--smoke`` runs the reduced config; without it the full config is
``make_config("train_4k")`` (the reference takes the grid's first shape).
Weights are random, made from seed 0 (``models.transformer.init``): the
real checkpoint is not in the repository. The batches are
``data.pipeline.lm_batches`` (seed 0) and the optimizer is AdamW with the
reference's settings (``lr``, ``total_steps = steps``, ``warmup_steps =
min(20, steps // 10)``). The loop (``train.loop.run``) checkpoints every
``--ckpt-every`` steps under ``--ckpt-dir`` and resumes from the newest
checkpoint there. ``--grad-compress`` routes the gradients through the
int8 error-feedback round trip (``--grad-compress-block N``: one scale per
N-element block); the loop owns the residual.

Not ported, because they belong to later slices (ROADMAP Queue 1): the
recsys and GNN families (items 7 and 8; their ``--arch`` raises
``NotImplementedError``); ``--fault-plan`` / ``--max-restarts`` (fault
recovery, item 6); ``--embed-shard``, ``--embed-*`` and ``--prefetch``
(the sharded embedding table's training, item 7); ``--profile``,
``--topology-aware``, ``--machine``, ``--map-restarts`` and ``--lint``
(meshes, their mapping search and the sharding lint, items 10 and 11).
One card has no mesh for them to act on.
"""
from __future__ import annotations

import argparse
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import configs, resolve_device, tree
from repro_torch.data import pipeline
from repro_torch.optim import adamw
from repro_torch.train import loop
from repro_torch.train.steps import make_train_step

_LATER = {"recsys": "recsys training waits for ROADMAP Queue 1, item 7",
          "gnn": "GNN training waits for ROADMAP Queue 1, item 8"}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="LM training on the port.",
        epilog="Not ported from the reference CLI: --fault-plan and "
               "--max-restarts (fault recovery), --embed-shard, --embed-* "
               "and --prefetch (embedding training), --profile, "
               "--topology-aware, --machine, --map-restarts and --lint "
               "(meshes and their lint).")
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
    return ap


def optimizer_config(lr: float, steps: int) -> adamw.AdamWConfig:
    """The CLI's AdamW settings for a run of ``steps`` steps."""
    return adamw.AdamWConfig(lr=lr, total_steps=steps,
                             warmup_steps=min(20, steps // 10))


def make_batches(vocab: int, batch: int, seq: int, device: torch.device,
                 seed: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    """``lm_batches`` as tensors on ``device``."""
    for b in pipeline.lm_batches(vocab, batch, seq, seed=seed):
        yield {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def train(args) -> tuple:
    """Build the model, optimizer, step and loop from parsed arguments and
    run; returns (params, opt_state, LoopResult)."""
    from repro_torch.models import transformer as tr
    arch = configs.get(args.arch)
    if arch.family != "lm":
        raise NotImplementedError(_LATER[arch.family])
    cfg = arch.smoke_config() if args.smoke else arch.make_config("train_4k")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = tr.init(cfg, gen, device=dev)
    n_params = sum(int(np.prod(x.shape)) for x in tree.leaves(params))
    print(f"arch={arch.name} params={n_params / 1e6:.1f}M devices=1 "
          f"({dev})", flush=True)
    grad_compress = args.grad_compress_block or args.grad_compress
    ocfg = optimizer_config(args.lr, args.steps)
    opt = adamw.init(params, ocfg)
    step = make_train_step(lambda p, b: tr.loss_fn(p, b, cfg), ocfg,
                           grad_compress=grad_compress)
    lcfg = loop.LoopConfig(total_steps=args.steps,
                           ckpt_every=args.ckpt_every,
                           ckpt_dir=args.ckpt_dir,
                           grad_compress=grad_compress)
    return loop.run(step, params, opt,
                    make_batches(cfg.vocab, args.batch, args.seq, dev), lcfg)


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    _, _, result = train(args)
    print(f"steps={result.steps_run} resumed_from={result.resumed_from} "
          f"loss {result.losses[0]:.4f} -> {result.losses[-1]:.4f} "
          f"({result.seconds:.1f}s, stragglers={result.straggler_steps})",
          flush=True)


if __name__ == "__main__":
    main()
