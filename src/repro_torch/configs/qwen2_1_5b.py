"""Qwen2-1.5B [arXiv:2407.10671; hf]: 28L d_model=1536 12H GQA kv=2
d_ff=8960 vocab=151936 — QKV bias. Twin of ``repro/configs/qwen2_1_5b.py``."""
import torch

from repro_torch.configs.lm_common import make_lm_archdef
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, qkv_bias=True,
    dtype=torch.bfloat16, remat=True)

SMOKE = TransformerConfig(
    name="qwen2-1.5b-smoke", n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=512, qkv_bias=True, dtype=torch.float32, remat=False)

ARCH = make_lm_archdef(FULL, SMOKE)
