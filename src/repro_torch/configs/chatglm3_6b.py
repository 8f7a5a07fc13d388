"""ChatGLM3-6B [arXiv:2406.12793; hf]: 28L d_model=4096 32H GQA kv=2
d_ff=13696 vocab=65024 — 2D RoPE (rotary on half the head dim), QKV bias.
Twin of ``repro/configs/chatglm3_6b.py``."""
import torch

from repro_torch.configs.lm_common import make_lm_archdef
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="chatglm3-6b", n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024, qkv_bias=True, rope_fraction=0.5,
    dtype=torch.bfloat16, remat=True)

SMOKE = TransformerConfig(
    name="chatglm3-6b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512, qkv_bias=True, rope_fraction=0.5,
    dtype=torch.float32, remat=False)

ARCH = make_lm_archdef(FULL, SMOKE, notes=(
    "Dense transformer: the paper's technique applies as logical-mesh -> "
    "physical-topology mapping (quotient traffic from HLO collectives), not "
    "intra-model graph partitioning."))
