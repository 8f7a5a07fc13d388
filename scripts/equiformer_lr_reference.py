"""Loss trajectories of the JAX reference's ``make_train_step`` beside the
port's for EquiformerV2 at full width, at several learning rates, on the
same params and batches: whether a loss that jumps in the first AdamW
steps (no warm-up in a 6-step run) is the model's own behaviour or the
port's, and which rate passes the card gate's rule (finite, and the mean
of the last two losses below the first).

``configs/equiformer_v2.py``'s ``make_config("molecule")`` (12 layers, 128
channels, l_max 6, m_max 2, 8 heads, d_in 16, 2 classes, graph-level) with
``remat``, on the first ``--graphs`` molecules of each
``molecule_batches(128, 30, 64, 16, 2, seed=0)`` batch (the card trains on
all 128; 16 keep a CPU step near 10 s). Both packages start from the
reference's ``init`` at ``PRNGKey(0)`` (through ``interop.gnn_tree_from``)
and take one batch a step, with the train CLI's optimizer settings
(``warmup_steps = min(20, steps // 10)``). One JSON line per lr: both
trajectories, the rule's verdict for each, and the largest relative
difference of the losses. Run on a CPU:

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/equiformer_lr_reference.py \\
        [--lrs 1e-3,3e-4,1e-4] [--steps 6] [--graphs 16]
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from chip_smoke import molecules_head
from repro.configs import equiformer_v2 as jeq_cfg
from repro.data.pipeline import molecule_batches
from repro.dist.sharding import gnn_rules
from repro.models import equiformer as jeq
from repro.optim import adamw as jadamw
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch import interop
from repro_torch.configs import equiformer_v2 as teq_cfg
from repro_torch.launch import train as tlaunch
from repro_torch.models import equiformer as teq
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step

RULES = gnn_rules(())


def progress(losses) -> bool:
    """The card gate's rule: finite, the mean of the last two losses below
    the first."""
    return bool(np.isfinite(losses).all()
                and np.mean(losses[-2:]) < losses[0])


def reference_run(cfg, params, batches, lr: float):
    steps = len(batches)
    ocfg = jadamw.AdamWConfig(lr=lr, total_steps=steps,
                              warmup_steps=min(20, steps // 10))
    step = jax.jit(jmake_train_step(
        lambda p, b: jeq.loss_fn(p, b, cfg, RULES), ocfg))
    p, o, out = params, jadamw.init(params, ocfg), []
    for b in batches:
        p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def port_run(cfg, params_np, batches, lr: float):
    ocfg = tlaunch.optimizer_config(lr, len(batches))
    step = make_train_step(lambda p, b: teq.loss_fn(p, b, cfg), ocfg)
    p = interop.gnn_tree_from(params_np)
    o, out = adamw.init(p, ocfg), []
    for b in batches:
        p, o, m = step(p, o, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lrs", default="1e-3,3e-4,1e-4")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--graphs", type=int, default=16)
    args = ap.parse_args(argv)
    jcfg = dataclasses.replace(jeq_cfg.ARCH.make_config("molecule"),
                               remat=True)
    tcfg = dataclasses.replace(teq_cfg.ARCH.make_config("molecule"),
                               remat=True)
    batches = [molecules_head(b, args.graphs) for b in itertools.islice(
        molecule_batches(128, 30, 64, 16, 2, seed=0), args.steps)]
    params, _ = jeq.init(jax.random.PRNGKey(0), jcfg, RULES)
    params_np = jax.tree.map(np.asarray, params)
    for lr in (float(x) for x in args.lrs.split(",")):
        t0 = time.perf_counter()
        ref = reference_run(jcfg, params, batches, lr)
        t1 = time.perf_counter()
        port = port_run(tcfg, params_np, batches, lr)
        t2 = time.perf_counter()
        ref_l = [x[0] for x in ref]
        port_l = [x[0] for x in port]
        print(json.dumps(dict(
            arch="equiformer-v2", config="molecule", lr=lr,
            steps=args.steps, graphs=args.graphs,
            nodes=int(batches[0]["x"].shape[0]),
            arcs=[len(b["senders"]) for b in batches],
            reference_losses=ref_l,
            reference_grad_norms=[x[1] for x in ref],
            port_losses=port_l, port_grad_norms=[x[1] for x in port],
            reference_passes=progress(ref_l), port_passes=progress(port_l),
            max_rel_loss_diff=float(np.max(np.abs(np.subtract(
                port_l, ref_l)) / np.abs(ref_l))),
            seconds=dict(reference=t1 - t0, port=t2 - t1))), flush=True)


if __name__ == "__main__":
    main()
