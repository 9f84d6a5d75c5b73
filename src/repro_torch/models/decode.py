"""Serving path of the "ssm" family: state cache layout, prefill and the
decode step. The port of the SSM part of the reference's `models/decode.py`.

Cache tensors are stacked over layers (leading L axis). Decode is
lockstep-batched: every sequence is at the same position.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..device import resolve_device
from . import ssm as ssm_mod
from .layers import rms_norm
from .transformer import (_embed_inputs, check_family, forward_hidden,
                          hybrid_segments, layer, logits_of)


# ---------------- cache layout ----------------

def cache_struct(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """{name: (shape, logical_axes)} for every cache tensor."""
    check_family(cfg)
    B = shape.global_batch
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    return {"conv": ((cfg.n_layers, B, s.conv_width - 1, di + 2 * s.d_state),
                     ("layers", "batch", None, "inner")),
            "ssm": ((cfg.n_layers, B, nh, s.d_state, s.head_dim),
                    ("layers", "batch", "act_heads", None, None))}


def init_cache(cfg: ModelConfig, shape: ShapeSpec, dtype=torch.bfloat16,
               device: str | torch.device | None = "cuda") -> dict:
    """Zero caches: conv in `dtype` (the working dtype), ssm in float32,
    and the position `pos` (an int32 scalar), on `device`."""
    dev = resolve_device(device)
    out = {name: torch.zeros(sh, dtype=torch.float32 if "ssm" in name else dtype,
                             device=dev)
           for name, (sh, _) in cache_struct(cfg, shape).items()}
    out["pos"] = torch.zeros((), dtype=torch.int32, device=dev)
    return out


# ---------------- decode step ----------------

def _ssm_decode_scan(params, cfg, x, cache):
    new_conv, new_ssm = [], []
    for a, b in hybrid_segments(cfg):
        for i in range(a, b):
            lp = layer(params["layers"], i)
            hn = rms_norm(x, lp["norm"], cfg.norm_eps)
            out, (nconv, nssm) = ssm_mod.mamba2_block(
                lp["mixer"], cfg, hn, state=(cache["conv"][i], cache["ssm"][i]))
            x = x + out
            new_conv.append(nconv)
            new_ssm.append(nssm)
    return x, {"conv": torch.stack(new_conv), "ssm": torch.stack(new_ssm)}


def decode_step(params, cfg: ModelConfig, cache: dict, batch: dict):
    """One token for every sequence. batch = {'tokens': [B, 1]}.

    Returns (logits [B, vocab] float32, new_cache with pos + 1); the cache
    passed in is left as it was.
    """
    x = _embed_inputs(params, cfg, batch)
    x, new_cache = _ssm_decode_scan(params, cfg, x, cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_of(params, x)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    new_cache["pos"] = cache["pos"] + 1
    return logits[:, 0], new_cache


def prefill(params, cfg: ModelConfig, batch: dict, *, use_kernel: bool = True):
    """Full-sequence forward for serving; returns last-position logits
    [B, vocab] float32.

    The reference computes the logits of every position and keeps the
    last; the port projects only the last position's hidden state, the
    same numbers without the [B, S, vocab] tensor (1.6 GB at B = 4,
    S = 2,048 for mamba2-370m).
    """
    x = forward_hidden(params, cfg, batch, use_kernel=use_kernel)
    return logits_of(params, x[:, -1])
