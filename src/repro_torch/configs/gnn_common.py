"""Shared ArchDef builder for GNN-family architectures (twin of
``repro/configs/gnn_common.py``)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

from repro_torch.configs import common as cc


def make_gnn_archdef(name: str, base_cfg, smoke_cfg,
                     flops_per_layer: Callable[[object, dict], float],
                     with_pos: bool = False, notes: str = "",
                     chunk_rule: Callable[[dict], int] = lambda m: 0
                     ) -> cc.ArchDef:
    """``base_cfg`` is the assignment config with placeholder d_in/classes;
    per-shape configs are derived. ``flops_per_layer(cfg, meta)`` returns
    forward FLOPs of one layer at that shape."""
    shapes = cc.gnn_shape_grid()

    def make_config(shape_name: str):
        meta = shapes[shape_name].meta
        return dataclasses.replace(
            base_cfg, d_in=meta["d_feat"], n_classes=meta["classes"],
            graph_level=bool(meta.get("graph_level")),
            edge_chunk=chunk_rule(meta))

    def smoke_batch() -> Dict[str, np.ndarray]:
        return cc.smoke_gnn_batch(n=64, deg=4, d_feat=smoke_cfg.d_in,
                                  n_classes=smoke_cfg.n_classes,
                                  with_pos=with_pos)

    def model_flops(shape_name: str) -> float:
        meta = shapes[shape_name].meta
        cfg = make_config(shape_name)
        fwd = base_cfg.n_layers * flops_per_layer(cfg, meta)
        # encode + decode heads
        h = getattr(cfg, "d_hidden", getattr(cfg, "channels", 0))
        fwd += 2.0 * meta["n"] * meta["d_feat"] * h
        fwd += 2.0 * meta["n"] * h * (h + meta["classes"])
        return 3.0 * fwd                     # train: fwd + 2x bwd

    return cc.ArchDef(
        name=name, family="gnn", make_config=make_config, shapes=shapes,
        smoke_config=lambda: smoke_cfg, smoke_batch=smoke_batch,
        model_flops=model_flops, notes=notes)
