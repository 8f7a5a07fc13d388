"""Model configurations the port runs: the two-tower retrieval config and
its shape grid (``two_tower_retrieval``), GIN-TU over the GNN shape grid
(``gin_tu`` on ``gnn_common``) and the LMs (on ``lm_common``): the dense
GQA ``qwen2-1.5b``, ``qwen2-72b`` and ``chatglm3-6b``, and the MoE + MLA
``deepseek-v2-lite-16b`` and ``deepseek-v2-236b``, on
``common.ShapeSpec`` / ``ArchDef``.

``REGISTRY`` / :func:`get` resolve the names the CLIs' ``--arch`` takes
(twin of ``repro/configs/__init__.py``'s registry, for the archs that are
ported)."""
from repro_torch.configs import (chatglm3_6b, deepseek_v2_236b,
                                 deepseek_v2_lite_16b, gin_tu, qwen2_1_5b,
                                 qwen2_72b, two_tower_retrieval)

REGISTRY = {a.ARCH.name: a.ARCH for a in (
    deepseek_v2_236b, deepseek_v2_lite_16b, chatglm3_6b, qwen2_72b,
    qwen2_1_5b, two_tower_retrieval, gin_tu)}


def get(name: str):
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[name]
