"""Architecture registry records shared by the port's model configs.

Twin of ``repro/configs/common.py``: ``ShapeSpec``, ``ArchDef``, the
LM, recsys and GNN shape grids, the GNN smoke batch, the LM model-FLOPs
count, and the input specs of every family's step. The reference's input
specs are ``jax.ShapeDtypeStruct``s; the port's (:func:`sds`) are tensors
on the ``meta`` device, which carry a shape and a dtype and allocate
nothing. Each input function returns ``(specs, logical)``: the meta
tensors and the logical axis names of their dims, which
:func:`logical_to_specs` resolves through a ``dist.sharding.Rules``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch


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


def sds(shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype``: the input spec of a step
    (the reference's ``jax.ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Input specs per family (meta tensors + logical axis names)
# ---------------------------------------------------------------------------

def lm_train_inputs(batch: int, seq: int):
    specs = {"tokens": sds((batch, seq), torch.int32),
             "labels": sds((batch, seq), torch.int32)}
    logical = {"tokens": ("batch", None), "labels": ("batch", None)}
    return specs, logical


def lm_prefill_inputs(batch: int, seq: int):
    specs = {"tokens": sds((batch, seq), torch.int32)}
    logical = {"tokens": ("batch", None)}
    return specs, logical


ROW_PAD = 512   # rows/arcs padded to the multi-pod device count


def _pad(n: int, m: int = ROW_PAD) -> int:
    return (n + m - 1) // m * m


def gnn_train_inputs(n: int, arcs: int, d_feat: int, n_labels: int,
                     with_pos: bool = False, graph_level: bool = False):
    n_raw = n
    n, arcs = _pad(n), _pad(arcs)
    if n_labels == n_raw:
        n_labels = n
    specs = {
        "x": sds((n, d_feat)),
        "senders": sds((arcs,), torch.int32),
        "receivers": sds((arcs,), torch.int32),
        "edge_weight": sds((arcs,)),
        "degrees": sds((n,)),
        "labels": sds((n_labels,), torch.int32),
        "label_mask": sds((n_labels,)),
    }
    logical = {
        "x": ("rows", None), "senders": ("rows",), "receivers": ("rows",),
        "edge_weight": ("rows",), "degrees": ("rows",),
        "labels": ("rows",), "label_mask": ("rows",),
    }
    if with_pos:
        specs["pos"] = sds((n, 3))
        logical["pos"] = ("rows", None)
    if graph_level:
        specs["graph_id"] = sds((n,), torch.int32)
        logical["graph_id"] = ("rows",)
    return specs, logical


def recsys_train_inputs(batch: int, hist: int, d_dense: int):
    specs = {
        "user_hist": sds((batch, hist), torch.int32),
        "user_dense": sds((batch, d_dense)),
        "item_id": sds((batch,), torch.int32),
        "item_cat": sds((batch,), torch.int32),
        "log_q": sds((batch,)),
    }
    logical = {k: ("batch",) + (None,) * (len(v.shape) - 1)
               for k, v in specs.items()}
    return specs, logical


def recsys_retrieve_inputs(hist: int, d_dense: int, n_cand: int,
                           embed_dim: int):
    specs = {
        "user_hist": sds((1, hist), torch.int32),
        "user_dense": sds((1, d_dense)),
        "cand_emb": sds((n_cand, embed_dim)),
    }
    logical = {"user_hist": (None, None), "user_dense": (None, None),
               "cand_emb": ("cand", None)}
    return specs, logical


def logical_to_specs(logical: Dict[str, Tuple], rules) -> Dict[str, Any]:
    return {k: rules.spec(*axes) for k, axes in logical.items()}


# ---------------------------------------------------------------------------
# Shape grids (shared per family)
# ---------------------------------------------------------------------------

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
