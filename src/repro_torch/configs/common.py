"""Shape-grid records shared by the port's model configs.

The part of ``repro/configs/common.py`` the recsys serving slice needs:
``ShapeSpec`` and the recsys shape grid (the JAX ``ShapeDtypeStruct`` input
specs of the dry-run are not ported).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                      # train | prefill | decode | score | retrieve | skip
    meta: Dict[str, Any]
    skip_reason: str = ""


def recsys_shape_grid() -> Dict[str, ShapeSpec]:
    return {
        "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
        "serve_p99": ShapeSpec("serve_p99", "score", {"batch": 512}),
        "serve_bulk": ShapeSpec("serve_bulk", "score", {"batch": 262144}),
        "retrieval_cand": ShapeSpec("retrieval_cand", "retrieve",
                                    {"batch": 1, "n_cand": 1_000_000}),
    }
