"""Loss trajectories of the JAX reference's ``make_train_step`` beside the
port's, at two learning rates, on the same params and batches: whether a
loss that jumps in the first AdamW steps (no warm-up in a 6-step run) is
the model's own behaviour or the port's.

PNA and MeshGraphNet at ``make_config("minibatch_lg")`` (full widths and
depths: PNA 4 x 75, MeshGraphNet 15 x 128, d_in 602, 41 classes) on
``minibatch_batches`` over ``random_regular(232,965, 50, seed=0)`` with
``gnn_features(g, 602, 41, seed=0)``: ``--seeds`` seed nodes a batch,
fanout (15, 10), padded in proportion to the grid's 1,024 seeds (169,984
nodes and 337,920 arcs at 1,024); GIN-TU at ``make_config("molecule")``
on ``molecule_batches(128, 30, 64, 16, 2, seed=0)``. Both packages start
from the reference's ``init`` at ``PRNGKey(0)`` (through
``interop.gnn_tree_from``) and take one batch a step, with the train CLI's
optimizer settings (``warmup_steps = min(20, steps // 10)``). One JSON
line per (kind, lr): both trajectories and the largest relative
difference of the losses, and the port's trajectory from its own
``init`` (CPU generator, seed 0) beside them. Run on a CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/gnn_train_lr_reference.py \\
        [--kinds pna,mgn,gin] [--lrs 3e-3,1e-3] [--steps 6] [--seeds 128]
"""
from __future__ import annotations

import argparse
import itertools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import gin_tu as jgin
from repro.configs import meshgraphnet as jmgn
from repro.configs import pna as jpna
from repro.data.pipeline import (gnn_features, minibatch_batches,
                                 molecule_batches)
from repro.dist.sharding import gnn_rules
from repro.graph.generators import random_regular
from repro.models import gnn as jgnn
from repro.optim import adamw as jadamw
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch import interop
from repro_torch.configs import gin_tu, meshgraphnet, pna
from repro_torch.launch import train as tlaunch
from repro_torch.models import gnn as tgnn
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step

ARCHS = {"pna": jpna.ARCH, "mgn": jmgn.ARCH, "gin": jgin.ARCH}
PORT_ARCHS = {"pna": pna.ARCH, "mgn": meshgraphnet.ARCH, "gin": gin_tu.ARCH}
FULL_SEEDS, FULL_NODES, FULL_ARCS = 1024, 169_984, 337_920
RULES = gnn_rules(())


def sampled_batches(seeds: int, steps: int):
    g = random_regular(232_965, 50, seed=0)
    feats = gnn_features(g, 602, 41, seed=0)
    return list(itertools.islice(minibatch_batches(
        g, feats, seeds, (15, 10), FULL_NODES * seeds // FULL_SEEDS,
        FULL_ARCS * seeds // FULL_SEEDS, seed=0), steps))


def reference_run(cfg, batches, lr: float):
    steps = len(batches)
    ocfg = jadamw.AdamWConfig(lr=lr, total_steps=steps,
                              warmup_steps=min(20, steps // 10))
    params, _ = jgnn.init(jax.random.PRNGKey(0), cfg, RULES)
    step = jax.jit(jmake_train_step(
        lambda p, b: jgnn.loss_fn(p, b, cfg, RULES), ocfg))
    p, o, out = params, jadamw.init(params, ocfg), []
    for b in batches:
        p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return jax.tree.map(np.asarray, params), out


def port_run(kind, shape, params_np, batches, lr: float):
    """The port's trajectory from ``params_np`` (the reference's draws),
    or from its own ``init`` (CPU generator, seed 0) where that is None."""
    cfg = PORT_ARCHS[kind].make_config(shape)
    ocfg = tlaunch.optimizer_config(lr, len(batches))
    step = make_train_step(lambda p, b: tgnn.loss_fn(p, b, cfg), ocfg)
    p = (tgnn.init(cfg, torch.Generator().manual_seed(0), device="cpu")
         if params_np is None else interop.gnn_tree_from(params_np))
    o, out = adamw.init(p, ocfg), []
    for b in batches:
        if kind == "gin":
            b = dict(b, **tgnn.gin_layouts(b, device="cpu"))
        p, o, m = step(p, o, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kinds", default="pna,mgn,gin")
    ap.add_argument("--lrs", default="3e-3,1e-3")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seeds", type=int, default=128)
    args = ap.parse_args()
    kinds = args.kinds.split(",")
    sampled = (sampled_batches(args.seeds, args.steps)
               if {"pna", "mgn"} & set(kinds) else None)
    for kind in kinds:
        if kind == "gin":
            batches = list(itertools.islice(
                molecule_batches(128, 30, 64, 16, 2, seed=0), args.steps))
            shape = "molecule"
        else:
            batches, shape = sampled, "minibatch_lg"
        cfg = ARCHS[kind].make_config(shape)
        for lr in map(float, args.lrs.split(",")):
            t0 = time.perf_counter()
            params, ref = reference_run(cfg, batches, lr)
            t1 = time.perf_counter()
            port = port_run(kind, shape, params, batches, lr)
            t2 = time.perf_counter()
            own = port_run(kind, shape, None, batches, lr)
            rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(port, ref))
            print(json.dumps(dict(
                kind=kind, config=shape, lr=lr, steps=args.steps,
                seeds=args.seeds if kind != "gin" else None,
                nodes=int(batches[0]["x"].shape[0]),
                arcs=int(batches[0]["senders"].shape[0]),
                reference_losses=[r[0] for r in ref],
                port_losses=[r[0] for r in port],
                reference_grad_norms=[r[1] for r in ref],
                port_grad_norms=[r[1] for r in port],
                port_own_init_losses=[r[0] for r in own],
                max_loss_rel_diff=rel,
                seconds=dict(reference=t1 - t0, port=t2 - t1))), flush=True)


if __name__ == "__main__":
    main()
