"""Qwen2-72B [arXiv:2407.10671; hf]: 80L d_model=8192 64H GQA kv=8
d_ff=29568 vocab=152064 — QKV bias. Twin of ``repro/configs/qwen2_72b.py``.
At 144 GB in bf16 it does not fit one card; the port runs its SMOKE
config."""
import torch

from repro_torch.configs.lm_common import make_lm_archdef
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen2-72b", n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, qkv_bias=True,
    dtype=torch.bfloat16, remat=True)

SMOKE = TransformerConfig(
    name="qwen2-72b-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=192, vocab=512, qkv_bias=True, dtype=torch.float32, remat=False)

ARCH = make_lm_archdef(FULL, SMOKE)
