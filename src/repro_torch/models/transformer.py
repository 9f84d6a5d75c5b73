"""Model assembly for the "ssm" family: param specs, the layer stack, the
full-sequence forward. The port of the SSM part of the reference's
`models/transformer.py`.

The reference scans over stacked params (`jax.lax.scan`); here the stack
is a Python loop over the layer axis of the same stacked tensors. Its
`constrain` and sharding rules are no-ops without a mesh, and one card has
none, so they are dropped. Attention, MoE, MLA and the hybrid, audio and
vision families raise `NotImplementedError` (ROADMAP Queue 1 #12).
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from . import ssm as ssm_mod
from .layers import ParamSpec, rms_norm

NOT_PORTED = "ROADMAP Queue 1 #12"


def check_family(cfg: ModelConfig) -> None:
    """Raise unless the port has model code for `cfg` (the "ssm" family)."""
    if cfg.family != "ssm" or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (frontend {cfg.frontend!r}) "
            f"is not ported; the port runs the 'ssm' family ({NOT_PORTED})")


# ---------------- param specs ----------------

def ssm_block_spec(cfg: ModelConfig) -> dict:
    return {"norm": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
            "mixer": ssm_mod.ssm_spec(cfg)}


def _stacked(spec, L: int):
    if isinstance(spec, ParamSpec):
        return ParamSpec((L,) + spec.shape, ("layers",) + spec.axes, spec.init)
    return {k: _stacked(v, L) for k, v in spec.items()}


def model_spec(cfg: ModelConfig) -> dict:
    check_family(cfg)
    d = cfg.d_model
    return {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed")),
        "final_norm": ParamSpec((d,), ("embed",), "zeros"),
        "layers": _stacked(ssm_block_spec(cfg), cfg.n_layers),
    }


# ---------------- stacks ----------------

def hybrid_segments(cfg: ModelConfig) -> list[tuple[int, int]]:
    """Layer ranges between shared-attention insertion points (zamba2):
    the shared block runs *before* each segment of attn_every ssm layers.
    One segment for the "ssm" family."""
    if cfg.family != "hybrid" or not cfg.attn_every:
        return [(0, cfg.n_layers)]
    return [(s, min(s + cfg.attn_every, cfg.n_layers))
            for s in range(0, cfg.n_layers, cfg.attn_every)]


def layer(tree, i: int) -> dict:
    """Layer i of a stacked param tree (views, no copies)."""
    return {k: layer(tree[k], i) if not isinstance(tree[k], torch.Tensor)
            else tree[k][i] for k in tree.keys()}


def _ssm_stack(params, cfg: ModelConfig, x, *, use_kernel: bool = True):
    for a, b in hybrid_segments(cfg):
        for i in range(a, b):
            lp = layer(params["layers"], i)
            hn = rms_norm(x, lp["norm"], cfg.norm_eps)
            out, _ = ssm_mod.mamba2_block(lp["mixer"], cfg, hn,
                                          use_kernel=use_kernel)
            x = x + out
    return x


def _embed_inputs(params, cfg: ModelConfig, batch: dict):
    """Token embeddings times sqrt(d_model) rounded to bf16, as the
    reference scales them (`transformer.py:283`). The factor is a Python
    float holding that bf16 value: the product keeps the embeddings' dtype,
    as JAX's promotion does, and no tensor is copied to the card."""
    check_family(cfg)
    scale = float(torch.tensor(math.sqrt(cfg.d_model)).to(torch.bfloat16))
    return params["embed"][batch["tokens"]] * scale


def forward_hidden(params, cfg: ModelConfig, batch: dict, *,
                   use_kernel: bool = True):
    """Embed + stack + final norm -> hidden [B, S, d] (no logits)."""
    x = _embed_inputs(params, cfg, batch)
    x = _ssm_stack(params, cfg, x, use_kernel=use_kernel)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def logits_of(params, x) -> torch.Tensor:
    """Tied-embedding logits [..., vocab] in float32 (the product runs in
    the params' dtype, then casts, as the reference's einsum does)."""
    return torch.matmul(x, params["embed"].transpose(0, 1)).to(torch.float32)


def forward(params, cfg: ModelConfig, batch: dict, *, use_kernel: bool = True):
    """Full-sequence forward -> logits [B, S, vocab] (fp32)."""
    return logits_of(params, forward_hidden(params, cfg, batch,
                                            use_kernel=use_kernel))
