"""Model/config system for the assigned architectures (the port's copy).

Every architecture is expressed as one ModelConfig; `reduced()` yields the
small-family smoke-test variant. A copy of the reference's
`configs/base.py`; `input_specs` gives the dry run's stand-ins for a
cell's inputs as tensors that hold no data (meta tensors, or fake ones
under a `FakeTensorMode`), where the reference gives
`jax.ShapeDtypeStruct`s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    d_ff_expert: int = 0          # expert hidden dim (may differ from dense d_ff)
    capacity_factor: float = 1.25
    ep: bool = False              # shard_map expert parallelism (moe_ep.py)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # attention flavor
    attn_pattern: tuple[str, ...] = ("global",)   # cycled over layers
    window: int = 4096            # local-attention window
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    mla: Optional[MLAConfig] = None
    # ffn / moe
    moe: Optional[MoEConfig] = None
    moe_every: int = 1            # 2 -> dense/MoE layer interleave (llama4)
    # ssm / hybrid
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0           # hybrid: shared attn block every k ssm layers
    # task shape
    encoder_only: bool = False
    frontend: Optional[str] = None   # None | 'audio' | 'vision'
    num_patches: int = 256           # vlm: vision tokens per image
    act: str = "silu"                # geglu activation (gemma: gelu)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- bookkeeping ----

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer attention flavor (cycled attn_pattern)."""
        p = self.attn_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Approximate total parameters (embedding + blocks)."""
        d, L = self.d_model, self.n_layers
        total = self.vocab * d                       # tied embedding
        if self.family in ("ssm", "hybrid"):
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            per = d * (2 * di + 2 * s.d_state + nh) + di * d \
                + s.conv_width * (di + 2 * s.d_state)
            total += L * per
            if self.family == "hybrid" and self.attn_every:
                hd = self.head_dim
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * hd * d + 3 * d * self.d_ff
        if self.family in ("dense", "moe", "audio", "vlm"):
            hd = self.head_dim
            if self.mla:
                m = self.mla
                attn = (d * m.q_lora_rank
                        + m.q_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                        + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                        + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                        + self.n_heads * m.v_head_dim * d)
            else:
                attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * hd * d
            if self.moe:
                e = self.moe
                moe_ffn = d * e.num_experts \
                    + e.num_experts * 3 * d * e.d_ff_expert \
                    + (3 * d * self.d_ff if e.num_shared else 0)
                n_moe = L // self.moe_every
                ffn_total = n_moe * moe_ffn + (L - n_moe) * 3 * d * self.d_ff
            else:
                ffn_total = L * 3 * d * self.d_ff
            total += L * attn + ffn_total
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (= param_count for dense)."""
        if not self.moe:
            return self.param_count()
        e = self.moe
        n_moe = self.n_layers // self.moe_every
        inactive = n_moe * (e.num_experts - e.top_k) * 3 * self.d_model * e.d_ff_expert
        return self.param_count() - inactive

    def reduced(self) -> "ModelConfig":
        """Same family, toy size: smoke tests run one step on CPU."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else 6),
            d_model=64, n_heads=4, head_dim=16,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128, vocab=512, window=8, num_patches=4)
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff_expert=64)
        if self.mla:
            kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8,
                                  v_head_dim=16)
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16,
                                            chunk=8)
        if self.attn_every:
            kw["attn_every"] = 2
        return dataclasses.replace(self, **kw)


# ---- assigned input shapes (LM family) ----

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; reason if skipped."""
    if cfg.encoder_only and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.is_ssm:
        return False, "524k decode needs sub-quadratic attention (DESIGN.md §4)"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                device: str | torch.device = "meta") -> dict:
    """Stand-ins for every model input of a cell, in the reference's shapes
    and dtypes (`frames` / `patches` bf16, `tokens` / `labels` int32), as
    empty tensors on `device`: "meta" allocates nothing, and under a
    `FakeTensorMode` any device gives fake tensors."""
    B, S = shape.global_batch, shape.seq_len

    def t(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=device)

    if shape.kind == "decode":       # one new token against a seq_len cache
        return {"tokens": t((B, 1))}
    out: dict = {}
    if cfg.frontend == "audio":
        out["frames"] = t((B, S, cfg.d_model), torch.bfloat16)
    elif cfg.frontend == "vision":
        st = S - cfg.num_patches
        out["patches"] = t((B, cfg.num_patches, cfg.d_model), torch.bfloat16)
        out["tokens"] = t((B, st))
    else:
        out["tokens"] = t((B, S))
    if shape.kind == "train":
        out["labels"] = t((B, S if cfg.frontend == "audio" else
                           out["tokens"].shape[1]))
    return out
