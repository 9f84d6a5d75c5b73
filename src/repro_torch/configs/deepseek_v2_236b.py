"""deepseek-v2-236b [moe] - MLA (kv_lora=512), 2 shared + 160 routed top-6
[arXiv:2405.04434; hf]."""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=3072,                       # 2 shared experts x 1536, fused
    vocab=102400, rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, num_shared=2, d_ff_expert=1536),
)
