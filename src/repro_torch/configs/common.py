"""Architecture registry records shared by the port's model configs.

The part of ``repro/configs/common.py`` the ported slices need:
``ShapeSpec``, ``ArchDef``, the LM, recsys and GNN shape grids, the GNN
smoke batch and the LM model-FLOPs count (the JAX ``ShapeDtypeStruct``
input specs of the dry-run are not ported).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                      # train | prefill | decode | score | retrieve | skip
    meta: Dict[str, Any]
    skip_reason: str = ""


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: str                    # lm | gnn | recsys
    make_config: Callable[[str], Any]          # shape name -> model config
    shapes: Dict[str, ShapeSpec]
    smoke_config: Callable[[], Any]
    smoke_batch: Callable[[], Dict[str, np.ndarray]]
    model_flops: Callable[[str], float]        # useful fwd+bwd (or fwd) FLOPs
    notes: str = ""
    profiles: Tuple[str, ...] = ("2d",)


def lm_shape_grid(full_attention: bool = True) -> Dict[str, ShapeSpec]:
    shapes = {
        "train_4k": ShapeSpec("train_4k", "train",
                              {"batch": 256, "seq": 4096}),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                                 {"batch": 32, "seq": 32768}),
        "decode_32k": ShapeSpec("decode_32k", "decode",
                                {"batch": 128, "seq": 32768}),
    }
    if full_attention:
        shapes["long_500k"] = ShapeSpec(
            "long_500k", "skip", {"batch": 1, "seq": 524288},
            skip_reason=("pure full-attention architecture; long_500k is "
                         "assigned only to SSM/hybrid/linear-attention "
                         "families (DESIGN.md §Arch-applicability)"))
    else:
        shapes["long_500k"] = ShapeSpec("long_500k", "decode",
                                        {"batch": 1, "seq": 524288})
    return shapes


def recsys_shape_grid() -> Dict[str, ShapeSpec]:
    return {
        "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
        "serve_p99": ShapeSpec("serve_p99", "score", {"batch": 512}),
        "serve_bulk": ShapeSpec("serve_bulk", "score", {"batch": 262144}),
        "retrieval_cand": ShapeSpec("retrieval_cand", "retrieve",
                                    {"batch": 1, "n_cand": 1_000_000}),
    }


GNN_SHAPE_META = {
    "full_graph_sm": {"n": 2708, "arcs": 10556, "d_feat": 1433,
                      "classes": 7},
    "minibatch_lg": {"n": 169984, "arcs": 337920, "d_feat": 602,
                     "classes": 41, "sampled": True,
                     "full_n": 232965, "full_arcs": 114615892,
                     "batch_nodes": 1024, "fanout": (15, 10)},
    "ogb_products": {"n": 2449029, "arcs": 61859140, "d_feat": 100,
                     "classes": 47},
    "molecule": {"n": 3840, "arcs": 16384, "d_feat": 16, "classes": 2,
                 "graphs": 128, "graph_level": True},
}


def gnn_shape_grid() -> Dict[str, ShapeSpec]:
    return {k: ShapeSpec(k, "train", dict(v))
            for k, v in GNN_SHAPE_META.items()}


def smoke_gnn_batch(n: int = 64, deg: int = 4, d_feat: int = 8,
                    n_classes: int = 4, with_pos: bool = False,
                    graphs: int = 0, seed: int = 0) -> Dict[str, np.ndarray]:
    from repro_torch.graph.generators import random_regular
    rng = np.random.default_rng(seed)
    g = random_regular(n, deg, seed=seed)
    batch = {
        "x": rng.normal(0, 1, (n, d_feat)).astype(np.float32),
        "senders": g.senders, "receivers": g.receivers,
        "edge_weight": g.edge_weight,
        "degrees": g.degrees().astype(np.float32),
    }
    if graphs:
        per = n // graphs
        batch["graph_id"] = np.repeat(np.arange(graphs), per).astype(np.int32)
        batch["labels"] = rng.integers(0, n_classes, graphs).astype(np.int32)
        batch["label_mask"] = np.ones(graphs, np.float32)
    else:
        batch["labels"] = rng.integers(0, n_classes, n).astype(np.int32)
        batch["label_mask"] = np.ones(n, np.float32)
    if with_pos:
        batch["pos"] = rng.normal(0, 1, (n, 3)).astype(np.float32)
    return batch


# LM model-FLOPs: the assignment's accounting — 6 * N(_active) * D tokens.
def lm_model_flops(n_params_active: int, shape: ShapeSpec) -> float:
    if shape.kind == "train":
        d = shape.meta["batch"] * shape.meta["seq"]
        return 6.0 * n_params_active * d
    if shape.kind == "prefill":
        d = shape.meta["batch"] * shape.meta["seq"]
        return 2.0 * n_params_active * d          # forward only
    if shape.kind == "decode":
        d = shape.meta["batch"]                    # one token per sequence
        return 2.0 * n_params_active * d
    return 0.0
