"""llama4-maverick-400b-a17b [moe] - MoE with dense/MoE interleave, shared
expert, top-1 of 128 routed [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=16384,                      # dense layers + shared expert width
    vocab=202048, rope_theta=500_000.0,
    moe=MoEConfig(num_experts=128, top_k=1, num_shared=1, d_ff_expert=8192),
    moe_every=2,
)
