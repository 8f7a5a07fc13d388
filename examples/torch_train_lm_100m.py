"""End-to-end example on the port: train a ~100M-parameter transformer for a
few hundred steps on the synthetic token pipeline, with checkpoint and
restart. Twin of ``examples/train_lm_100m.py``: the same 12 x 512 float32
model, AdamW (lr 1e-3, 20 warm-up steps), ``train.loop.run`` with a
checkpoint every 100 steps. Each layer's attention runs the
``flash_attention`` kernel (float32, head dim 64, with its log-sum-exp for
the backward) on the card; ``--device cpu`` runs its plain version.

    PYTHONPATH=src python examples/torch_train_lm_100m.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_lm_100m.py --device cpu \\
        --steps 2 --batch 1 --seq 16

The last line gives the kernel launches the run made.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device, tree
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw
from repro_torch.train import loop
from repro_torch.train.steps import make_train_step

CFG = tr.TransformerConfig(
    name="lm-100m", n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
    d_ff=2048, vocab=49152, qkv_bias=False, dtype=torch.float32,
    remat=False, q_chunk=128, kv_chunk=128)   # ~97M params


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm100m"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = tr.init(CFG, gen, device=dev)
    n = sum(int(np.prod(x.shape)) for x in tree.leaves(params))
    print(f"model: {n/1e6:.1f}M params")

    ocfg = adamw.AdamWConfig(lr=1e-3, total_steps=args.steps,
                             warmup_steps=20)
    opt = adamw.init(params, ocfg)
    step = make_train_step(lambda p, b: tr.loss_fn(p, b, CFG), ocfg)

    def batches():
        for b in pipeline.lm_batches(CFG.vocab, args.batch, args.seq,
                                     seed=0):
            yield {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    lcfg = loop.LoopConfig(total_steps=args.steps, ckpt_every=100,
                           ckpt_dir=args.ckpt_dir, log_every=20)
    ops.reset_launch_counts()
    params, opt, result = loop.run(step, params, opt, batches(), lcfg)
    ls = result.losses
    print(f"loss: {ls[0]:.3f} -> {np.mean(ls[-10:]):.3f} over "
          f"{result.steps_run} steps in {result.seconds:.0f}s "
          f"(resumed_from={result.resumed_from})")
    assert np.mean(ls[-10:]) < ls[0], "model failed to learn"
    counts = ops.launch_counts()
    print("kernel launches: " + " ".join(f"{k}={v}" for k, v in
                                         sorted(counts.items()) if v))


if __name__ == "__main__":
    main()
