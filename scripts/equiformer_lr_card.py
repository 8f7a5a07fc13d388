"""EquiformerV2's loss trajectory on the card at several learning rates, on
the params and batches of ``chip_smoke.py``'s ``equiformer`` phase: full
width (``make_config("molecule")``, 12 x 128, l_max 6, m_max 2, remat),
float32 with TF32 off, ``init`` from a CUDA ``torch.Generator`` at seed 0,
``molecule_batches(128, 30, 64, 16, 2, seed=0)``, one batch a step, the
train CLI's optimizer settings. One JSON line per lr with the losses, the
grad norms and the phase's progress rule (finite, the mean of the last two
losses below the first). Run on a machine with a card:

    PYTHONPATH=src:. python scripts/equiformer_lr_card.py \\
        [--lrs 1e-3,3e-4,1e-4] [--steps 6]
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time

import numpy as np
import torch

from chip_smoke import nvidia_smi_line
from repro_torch.configs import equiformer_v2
from repro_torch.data.pipeline import molecule_batches
from repro_torch.launch import train as tlaunch
from repro_torch.models import equiformer
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lrs", default="1e-3,3e-4,1e-4")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(equiformer_v2.ARCH.make_config("molecule"),
                              remat=True)
    batches = [tlaunch.to_device(b, dev) for b in itertools.islice(
        molecule_batches(128, 30, 64, 16, 2, seed=0), args.steps)]
    smi = nvidia_smi_line()
    for lr in (float(x) for x in args.lrs.split(",")):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = equiformer.init(cfg, gen, device=dev)
        ocfg = tlaunch.optimizer_config(lr, args.steps)
        step = make_train_step(lambda p, b: equiformer.loss_fn(p, b, cfg),
                               ocfg)
        opt, losses, norms = adamw.init(params, ocfg), [], []
        t0 = time.perf_counter()
        for b in batches:
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        print(json.dumps(dict(
            arch="equiformer-v2", config="molecule", lr=lr,
            steps=args.steps, losses=losses, grad_norms=norms,
            passes=bool(np.isfinite(losses + norms).all()
                        and np.mean(losses[-2:]) < losses[0]),
            seconds=time.perf_counter() - t0, nvidia_smi=smi)), flush=True)
        del params, opt
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
