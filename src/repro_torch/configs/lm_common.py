"""Shared ArchDef builder for the LM-family transformers (twin of
``repro/configs/lm_common.py``). Every LM traces under all four sharding
profiles (``dist.sharding.LM_PROFILES``), as in the reference: ``expert``
moves only a MoE arch's expert dim, so on a dense arch it is ``2d``."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs import common as cc
from repro_torch.dist.sharding import LM_PROFILES
from repro_torch.models.transformer import TransformerConfig


def make_lm_archdef(full: TransformerConfig, smoke: TransformerConfig,
                    notes: str = "") -> cc.ArchDef:
    shapes = cc.lm_shape_grid(full_attention=True)

    def make_config(shape_name: str) -> TransformerConfig:
        meta = shapes[shape_name].meta
        return dataclasses.replace(full, max_seq=meta["seq"])

    def smoke_batch() -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(0)
        toks = rng.integers(0, smoke.vocab, (2, 32)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def model_flops(shape_name: str) -> float:
        return cc.lm_model_flops(full.n_active_params(), shapes[shape_name])

    return cc.ArchDef(
        name=full.name, family="lm", make_config=make_config, shapes=shapes,
        smoke_config=lambda: smoke, smoke_batch=smoke_batch,
        model_flops=model_flops, notes=notes, profiles=LM_PROFILES)
