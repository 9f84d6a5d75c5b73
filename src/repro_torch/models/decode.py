"""Serving path: KV / state cache layout, prefill and the decode step for
every family. The port of the reference's `models/decode.py`.

Cache tensors are stacked over layers (leading L axis). Decode is
lockstep-batched: every sequence is at the same position.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..device import resolve_device
from ..sharding.rules import constrain, gathered, tp_size
from . import ssm as ssm_mod
from .layers import _softcap, embed_rows, rms_norm
from .transformer import (attn_layers, block_decode, embed_scale,
                          forward_hidden, hybrid_segments, layer, logits_of,
                          moe_interleave)


# ---------------- cache layout ----------------

def _attn_cache_struct(cfg: ModelConfig, L: int, B: int, S: int) -> dict:
    """The GQA cache, or MLA's latent and rope-key caches, whose sequence
    axis is always sharded over the tensor axis. A GQA cache whose kv
    heads do not divide the tensor axis (`tp_size()`) shards its sequence
    over that axis instead of its heads, as the reference's does: a
    replicated cache both overflows the device (48 layers x 32k x 8 kv
    heads) and would be gathered whole for every decoded token."""
    if cfg.mla:
        m = cfg.mla
        axes = ("layers", "batch", "act_seq_tp", None)
        return {"lat": ((L, B, S, m.kv_lora_rank), axes),
                "rope": ((L, B, S, m.qk_rope_head_dim), axes)}
    kv_div = cfg.n_kv_heads % tp_size() == 0
    axes = ("layers", "batch", "act_seq" if kv_div else "act_seq_tp",
            "act_kv" if kv_div else None, None)
    return {"k": ((L, B, S, cfg.n_kv_heads, cfg.head_dim), axes),
            "v": ((L, B, S, cfg.n_kv_heads, cfg.head_dim), axes)}


def cache_struct(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """{name: (shape, logical_axes)} for every cache tensor: the dense /
    MoE interleave's caches are "dense_*" and "moe_*"."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        nh = s.n_heads(cfg.d_model)
        out = {"conv": ((cfg.n_layers, B, s.conv_width - 1, di + 2 * s.d_state),
                        ("layers", "batch", None, "inner")),
               "ssm": ((cfg.n_layers, B, nh, s.d_state, s.head_dim),
                       ("layers", "batch", "act_heads", None, None))}
        if cfg.family == "hybrid" and cfg.attn_every:
            n_attn = len(hybrid_segments(cfg))
            out |= {f"attn_{k}": v for k, v in
                    _attn_cache_struct(cfg, n_attn, B, S).items()}
        return out
    unit = moe_interleave(cfg)
    L = cfg.n_layers // unit
    if unit == 1:
        return _attn_cache_struct(cfg, L, B, S)
    out = {}
    for part in ("dense", "moe"):
        out |= {f"{part}_{k}": v for k, v in
                _attn_cache_struct(cfg, L, B, S).items()}
    return out


def init_cache(cfg: ModelConfig, shape: ShapeSpec, dtype=torch.bfloat16,
               device: str | torch.device | None = "cuda") -> dict:
    """Zero caches: "ssm" in float32, the others (k / v, lat / rope, conv)
    in `dtype` (the working dtype), and the position `pos` (an int32 scalar), on
    `device`."""
    dev = resolve_device(device)
    out = {name: torch.zeros(sh, dtype=torch.float32 if "ssm" in name else dtype,
                             device=dev)
           for name, (sh, _) in cache_struct(cfg, shape).items()}
    out["pos"] = torch.zeros((), dtype=torch.int32, device=dev)
    return out


# ---------------- decode step ----------------

def _attn_decode_scan(params, cfg, x, pos, cache):
    keys = ("lat", "rope") if cfg.mla else ("k", "v")
    for lp, w, moe_layer, prefix, i in attn_layers(params, cfg):
        x, _ = block_decode(lp, cfg, x, pos,
                            {k: cache[prefix + k][i] for k in keys}, w,
                            moe_layer=moe_layer)
    return x, {name: v for name, v in cache.items() if name != "pos"}


def _ssm_decode_scan(params, cfg, x, pos, cache):
    use_shared = cfg.family == "hybrid" and cfg.attn_every
    new_conv, new_ssm = [], []
    for j, (a, b) in enumerate(hybrid_segments(cfg)):
        if use_shared:
            x, _ = block_decode(params["shared_attn"], cfg, x, pos,
                                {"k": cache["attn_k"][j],
                                 "v": cache["attn_v"][j]}, -1)
        for i in range(a, b):
            lp = layer(params["layers"], i)
            hn = rms_norm(x, lp["norm"], cfg.norm_eps)
            out, (nconv, nssm) = ssm_mod.mamba2_block(
                lp["mixer"], cfg, hn, state=(cache["conv"][i], cache["ssm"][i]))
            x = x + out
            new_conv.append(nconv)
            new_ssm.append(nssm)
    new_cache = {"conv": torch.stack(new_conv), "ssm": torch.stack(new_ssm)}
    if use_shared:
        new_cache |= {"attn_k": cache["attn_k"], "attn_v": cache["attn_v"]}
    return x, new_cache


def decode_step(params, cfg: ModelConfig, cache: dict, batch: dict):
    """One token for every sequence. batch = {'tokens': [B, 1]}.

    Returns (logits [B, vocab] float32, softcapped where the config says,
    and new_cache with pos + 1). The attention caches ("k" / "v", MLA's
    "lat" / "rope", the interleave's "dense_*" / "moe_*", the hybrid's
    "attn_k" / "attn_v") are written in place at pos and returned as the
    same tensors, as the reference's `generate` donates its cache;
    "conv", "ssm" and "pos" are new tensors, and the old ones are left as
    they were.
    """
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = constrain(embed_rows(gathered(params["embed"]), tokens)
                  * embed_scale(cfg), "batch", None, None)
    pos = constrain(cache["pos"].expand(B, 1), "batch", None)
    if cfg.family in ("ssm", "hybrid"):
        x, new_cache = _ssm_decode_scan(params, cfg, x, pos, cache)
    else:
        x, new_cache = _attn_decode_scan(params, cfg, x, pos, cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _softcap(logits_of(params, x), cfg.logit_softcap)
    new_cache["pos"] = cache["pos"] + 1
    return constrain(logits[:, 0], "batch", "vocab"), new_cache


def prefill(params, cfg: ModelConfig, batch: dict, *, chunk=1024,
            use_kernel: bool = True):
    """Full-sequence forward for serving; returns last-position logits
    [B, vocab] float32, without the `logit_softcap`, as the reference's.

    The reference computes the logits of every position and keeps the
    last; the port projects only the last position's hidden state, the
    same numbers without the [B, S, vocab] tensor (1.6 GB at B = 4,
    S = 2,048 for mamba2-370m; 10 GB at B = 2, S = 5,120 for gemma2-27b).
    """
    x = forward_hidden(params, cfg, batch, chunk=chunk, use_kernel=use_kernel)
    return constrain(logits_of(params, x[:, -1]), "batch", "vocab")
