"""Two-tower retrieval [RecSys'19 (YouTube); unverified]: embed_dim=256,
tower MLPs 1024-512-256, dot interaction, sampled softmax with logQ. Twin
of ``repro/configs/two_tower_retrieval.py`` (``FULL``, ``SMOKE``, the shape
grid, ``make_config``, ``smoke_batch``, ``model_flops`` and ``ARCH``)."""
from typing import Dict

import numpy as np

from repro_torch.configs import common as cc
from repro_torch.models.recsys import TwoTowerConfig

FULL = TwoTowerConfig(name="two-tower-retrieval", n_items=1_000_000,
                      n_cats=10_000, embed_dim=256,
                      tower_mlp=(1024, 512, 256), hist_len=50, d_dense=16)

SMOKE = TwoTowerConfig(name="two-tower-smoke", n_items=1000, n_cats=50,
                       embed_dim=32, tower_mlp=(64, 32), hist_len=10,
                       d_dense=4)

SHAPES = cc.recsys_shape_grid()


def make_config(shape_name: str) -> TwoTowerConfig:
    return FULL


def smoke_batch() -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    b = 16
    return {
        "user_hist": rng.integers(-1, SMOKE.n_items,
                                  (b, SMOKE.hist_len)).astype(np.int32),
        "user_dense": rng.normal(0, 1, (b, SMOKE.d_dense)).astype(np.float32),
        "item_id": rng.integers(0, SMOKE.n_items, b).astype(np.int32),
        "item_cat": rng.integers(0, SMOKE.n_cats, b).astype(np.int32),
        "log_q": np.zeros(b, np.float32),
    }


def model_flops(shape_name: str) -> float:
    sp = SHAPES[shape_name]
    b = sp.meta["batch"]
    e = FULL.embed_dim
    dims_u = [e + FULL.d_dense] + list(FULL.tower_mlp)
    dims_i = [2 * e] + list(FULL.tower_mlp)
    towers = sum(2.0 * a * o for a, o in zip(dims_u[:-1], dims_u[1:]))
    towers += sum(2.0 * a * o for a, o in zip(dims_i[:-1], dims_i[1:]))
    bag = 2.0 * FULL.hist_len * e
    if sp.kind == "train":
        return 3.0 * b * (towers + bag + 2.0 * b * FULL.tower_mlp[-1] / b)
    if sp.kind == "score":
        return b * (towers + bag + 2.0 * FULL.tower_mlp[-1])
    if sp.kind == "retrieve":
        return towers + bag + 2.0 * sp.meta["n_cand"] * e
    return 0.0


ARCH = cc.ArchDef(
    name="two-tower-retrieval", family="recsys", make_config=make_config,
    shapes=SHAPES, smoke_config=lambda: SMOKE, smoke_batch=smoke_batch,
    model_flops=model_flops,
    notes=("Embedding tables row-sharded; the paper's technique applies as "
           "table-shard placement (vertex-weighted makespan over co-access "
           "graph)."))
