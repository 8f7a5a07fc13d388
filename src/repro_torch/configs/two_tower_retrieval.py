"""Two-tower retrieval [RecSys'19 (YouTube); unverified]: embed_dim=256,
tower MLPs 1024-512-256, dot interaction. Twin of
``repro/configs/two_tower_retrieval.py`` (its ``FULL``, ``SMOKE``, shape
grid and ``smoke_batch``)."""
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
