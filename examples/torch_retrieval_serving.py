"""Two-tower retrieval end to end on the port: brief training with the
in-batch sampled softmax (+logQ), then batched serving — pointwise
scoring and 1-vs-100k candidate retrieval with top-k. Twin of
``examples/retrieval_serving.py``.

    PYTHONPATH=src python examples/torch_retrieval_serving.py   # the card
    PYTHONPATH=src python examples/torch_retrieval_serving.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data import pipeline
from repro_torch.models import recsys as rs
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: cuda; 'cpu' runs the plain "
                     "PyTorch path)")
ap.add_argument("--steps", type=int, default=60)
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = rs.TwoTowerConfig(name="demo", n_items=100_000, n_cats=500,
                        embed_dim=64, tower_mlp=(128, 64), hist_len=20,
                        d_dense=8)
params = rs.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

ocfg = adamw.AdamWConfig(lr=3e-3, total_steps=args.steps, warmup_steps=5,
                         weight_decay=0.0)
opt = adamw.init(params, ocfg)
step = make_train_step(lambda p, b: rs.loss_fn(p, b, cfg), ocfg)
gen = pipeline.recsys_batches(cfg.n_items, cfg.n_cats, 128, cfg.hist_len,
                              cfg.d_dense, seed=0)


def on_device(b):
    return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}


losses = []
for _ in range(args.steps):
    params, opt, m = step(params, opt, on_device(next(gen)))
    losses.append(float(m["loss"]))
print(f"train: loss {losses[0]:.3f} -> {losses[-1]:.3f}")


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize()


# serving: pointwise scores for a request batch
b = on_device(next(gen))
with torch.no_grad():
    rs.score(params, b, cfg)                  # first call untimed
    sync()
    t0 = time.time()
    s = rs.score(params, b, cfg)
    sync()
print(f"serve_p99 path: scored {s.shape[0]} pairs in "
      f"{(time.time() - t0) * 1e3:.1f} ms")

# retrieval: embed 100k candidate items once, then 1 query vs all
item_ids = torch.arange(cfg.n_items, device=dev)
cat_of = torch.as_tensor(np.random.default_rng(0).integers(
    0, cfg.n_cats, cfg.n_items), device=dev)
with torch.no_grad():
    cand = rs.item_embed(params, {"item_id": item_ids, "item_cat": cat_of},
                         cfg)
    query = {"user_hist": b["user_hist"][:1],
             "user_dense": b["user_dense"][:1], "cand_emb": cand}
    rs.retrieve(params, query, cfg, top_k=10)
    sync()
    t0 = time.time()
    vals, idx = rs.retrieve(params, query, cfg, top_k=10)
    sync()
print(f"retrieval: top-10 of {cfg.n_items} candidates in "
      f"{(time.time() - t0) * 1e3:.1f} ms -> items {idx.tolist()}")
