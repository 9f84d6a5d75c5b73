"""mamba2-370m [ssm] - attention-free SSD [arXiv:2405.21060; unverified]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=64),
)
