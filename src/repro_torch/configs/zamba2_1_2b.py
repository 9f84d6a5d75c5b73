"""zamba2-1.2b [hybrid] - Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4, chunk=64),
    attn_every=6,
)
