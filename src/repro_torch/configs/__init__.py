"""Architecture registry: --arch <id> -> ModelConfig (plain data, as in the
reference). Only the "ssm" family has model code in the port so far."""
from . import (deepseek_v2_236b, gemma2_27b, gemma3_27b, gemma_7b,
               hubert_xlarge, internlm2_20b, internvl2_1b,
               llama4_maverick_400b_a17b, mamba2_370m, zamba2_1_2b)
from .base import SHAPES, ModelConfig, ShapeSpec, cell_supported  # noqa: F401

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (
        llama4_maverick_400b_a17b, deepseek_v2_236b, internlm2_20b,
        gemma2_27b, gemma3_27b, gemma_7b, zamba2_1_2b, mamba2_370m,
        hubert_xlarge, internvl2_1b)
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
