"""gemma-7b [dense] - GeGLU(gelu), head_dim=256 [arXiv:2403.08295; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000, act="gelu",
)
