"""The paper's flagship integration on the port: partition a graph with
the makespan objective over the machine tree, permute node arrays into
bin blocks, and train a GIN on the placed graph, its sum aggregation
through the ``bsr_spmm`` kernel forward and on the transposed layout
backward. Reports the halo-exchange volume on the hottest link (the
paper's comm(l)) against a hashed partition. Twin of
``examples/gnn_partitioned_training.py``.

    PYTHONPATH=src python examples/torch_gnn_partitioned_training.py
    PYTHONPATH=src python examples/torch_gnn_partitioned_training.py \\
        --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import baselines
from repro_torch.core.mapping import apply_placement, block_placement
from repro_torch.core.partitioner import PartitionConfig, partition
from repro_torch.core.topology import production_tree
from repro_torch.data import pipeline
from repro_torch.graph.generators import rmat
from repro_torch.models import gnn
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step

CFG = gnn.GNNConfig(name="gin", kind="gin", n_layers=3, d_hidden=64,
                    d_in=32, n_classes=8)


def placed_batch(g, topo, part, d_feat=32, n_classes=8):
    """The node-classification batch of ``g`` in the block placement of
    ``part`` (host arrays; padding rows have no arcs and no label)."""
    pl = block_placement(part, topo.k)
    g2 = apply_placement(g, pl)
    feats = pipeline.gnn_features(g, d_feat, n_classes, seed=0)
    x = np.zeros((pl.n_pad, d_feat), np.float32)
    x[pl.perm] = feats["x"]
    labels = np.zeros(pl.n_pad, np.int32)
    labels[pl.perm] = feats["labels"]
    mask = np.zeros(pl.n_pad, np.float32)
    mask[pl.perm] = 1.0
    return {"x": x, "labels": labels, "label_mask": mask,
            "senders": g2.senders, "receivers": g2.receivers,
            "edge_weight": g2.edge_weight,
            "degrees": g2.degrees().astype(np.float32)}


def train(batch, params, steps, device, total_steps=80):
    """``steps`` AdamW steps (lr 3e-3, cosine over ``total_steps``, no
    warm-up) of GIN on ``batch``, with its BSR layouts on ``device``.
    Returns (params, losses)."""
    dev = resolve_device(device)
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    b.update(gnn.gin_layouts(batch, device=dev))
    ocfg = adamw.AdamWConfig(lr=3e-3, total_steps=total_steps,
                             warmup_steps=0)
    opt = adamw.init(params, ocfg)
    step = make_train_step(lambda p, bt: gnn.loss_fn(p, bt, CFG), ocfg)
    losses = []
    for _ in range(steps):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--steps", type=int, default=80)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = rmat(2000, 12000, seed=0)
    topo = production_tree(2, 2, 4)     # 2 pods x 2 rows x 4 chips
    res = partition(g, topo, PartitionConfig(seed=0), device=dev)
    rand = baselines.random_partition(g.n_nodes, topo.k)
    s_ours = baselines.score_all(g, topo, res.part, device=dev)
    s_rand = baselines.score_all(g, topo, rand, device=dev)
    print(f"halo bottleneck (comm_max): partitioned={s_ours['comm_max']:.0f}"
          f" vs hashed={s_rand['comm_max']:.0f} "
          f"({s_rand['comm_max'] / s_ours['comm_max']:.1f}x less traffic "
          f"on the hottest link)")

    batch = placed_batch(g, topo, res.part)
    params = gnn.init(CFG, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    _, losses = train(batch, params, args.steps, dev, total_steps=80)
    print(f"GIN on the placed graph: loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}")


if __name__ == "__main__":
    main()
