"""internvl2-1b [vlm] - InternViT patch embeddings (stub) + InternLM2 decoder
[arXiv:2404.16821; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab=151655, rope_theta=1_000_000.0,
    frontend="vision", num_patches=256,
)
