"""DeepSeek-V2 236B [arXiv:2405.04434; hf]: 60L d_model=5120 128H MLA
(kv_lora=512, q_lora=1536), vocab=102400, MoE 2 shared + 160 routed top-6,
expert d_ff=1536, first layer dense (d_ff=12288). Twin of
``repro/configs/deepseek_v2_236b.py``. At 472 GB in bf16 it does not fit
one card; the card runs a cut of its depth."""
import torch

from repro_torch.configs.lm_common import make_lm_archdef
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
    n_kv_heads=128, d_ff=12288, vocab=102400,
    moe=True, n_experts=160, n_shared=2, top_k=6, d_ff_expert=1536,
    n_dense_layers=1, mla=True, kv_lora_rank=512, q_lora_rank=1536,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    dtype=torch.bfloat16, remat=True)

SMOKE = TransformerConfig(
    name="deepseek-v2-236b-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=512,
    moe=True, n_experts=8, n_shared=2, top_k=2, d_ff_expert=32,
    n_dense_layers=1, mla=True, kv_lora_rank=16, q_lora_rank=24,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    dtype=torch.float32, remat=False, capacity_factor=4.0)

ARCH = make_lm_archdef(FULL, SMOKE)
