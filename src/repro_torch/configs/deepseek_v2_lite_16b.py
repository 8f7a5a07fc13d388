"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf]: 27L d_model=2048 16H MLA
(kv_lora=512, no q_lora), vocab=102400, MoE 2 shared + 64 routed top-6,
expert d_ff=1408, first layer dense (d_ff=10944). Twin of
``repro/configs/deepseek_v2_lite_16b.py``: 15.7B parameters, 31.4 GB in
bf16, which one 80 GB card holds whole."""
import torch

from repro_torch.configs.lm_common import make_lm_archdef
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=10944, vocab=102400,
    moe=True, n_experts=64, n_shared=2, top_k=6, d_ff_expert=1408,
    n_dense_layers=1, mla=True, kv_lora_rank=512, q_lora_rank=0,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    dtype=torch.bfloat16, remat=True)

SMOKE = TransformerConfig(
    name="deepseek-v2-lite-16b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=512,
    moe=True, n_experts=8, n_shared=2, top_k=2, d_ff_expert=32,
    n_dense_layers=1, mla=True, kv_lora_rank=16, q_lora_rank=0,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    dtype=torch.float32, remat=False, capacity_factor=4.0)

ARCH = make_lm_archdef(FULL, SMOKE)
