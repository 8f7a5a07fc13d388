"""Peak device memory of DeepSeek-V2-Lite training on the card at several
depth cuts: the bound behind ``TRAIN_MLA_LAYERS`` in ``chip_smoke.py``.

Each cut is ``make_config("train_4k")`` (FULL widths, bf16, remat,
capacity factor 1.5) with ``n_layers`` replaced (the first layer dense,
the rest MoE), weights from a CUDA ``torch.Generator`` at seed 0, and
``--steps`` AdamW steps of ``lm_batches(102400, 4, 4,096, seed=0)``
through ``loop.run``, which holds the only reference to the initial
params, as the smoke's ``train_mla`` phase runs them. One JSON line per
cut: the parameter count, ``max_memory_allocated`` over the run, the
step seconds and losses, or the out-of-memory error. Run on a machine
with a card:

    PYTHONPATH=src:. python scripts/mla_train_memory.py [--layers 4,5,6] \\
        [--steps 2]
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time

import torch

from chip_smoke import MLA_ARCH, TRAIN_MLA_BATCH, nvidia_smi_line
from repro_torch import configs
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw
from repro_torch.train import loop
from repro_torch.train.steps import make_train_step


def measure(layers: int, steps: int) -> dict:
    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get(MLA_ARCH).make_config("train_4k"),
                              n_layers=layers)
    b, s = TRAIN_MLA_BATCH
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ocfg = tlaunch.optimizer_config(3e-3, steps)
    step = make_train_step(lambda p, bt: tr.loss_fn(p, bt, cfg), ocfg)
    batches = itertools.islice(tlaunch.make_batches(cfg.vocab, b, s, dev),
                               steps)
    out = dict(layers=layers, params=cfg.n_params(), steps=steps)
    torch.cuda.reset_peak_memory_stats()
    times = []

    def timed(p, o, bt):
        t0 = time.perf_counter()
        res = step(p, o, bt)
        float(res[-1]["loss"])
        times.append(time.perf_counter() - t0)
        return res
    try:
        args = [tr.init(cfg, gen, device=dev)]
        args.append(adamw.init(args[0], ocfg))
        after_init = torch.cuda.memory_allocated()
        p, o, result = loop.run(timed, args.pop(0), args.pop(0), batches,
                                loop.LoopConfig(total_steps=steps))
        del p, o
        out.update(bytes_after_init=after_init, losses=result.losses,
                   step_s=times)
    except torch.OutOfMemoryError as e:
        out["out_of_memory"] = str(e).split("\n")[0]
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["bytes_per_param_at_peak"] = out["max_memory_allocated"] / \
        out["params"]
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", default="4,5,6")
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    smi = nvidia_smi_line()
    for layers in (int(x) for x in args.layers.split(",")):
        print(json.dumps(dict(measure(layers, args.steps), nvidia_smi=smi)),
              flush=True)


if __name__ == "__main__":
    main()
