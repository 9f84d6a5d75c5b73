"""DeepSeek-V2 Multi-head Latent Attention (arXiv:2405.04434): the port of
the reference's `models/mla.py`.

Queries and KV are projected through low-rank latents; only the
kv_lora_rank latent and the shared rope key are cached at decode time.
Per head, q and k have qk_nope + qk_rope dims (192 in deepseek-v2) and v
its own head dim (128); the rope key is one head broadcast to all H heads,
so `attend` runs with G = H kv heads and scales by sqrt(192). Decode writes
the two caches in place at pos and expands the whole latent cache through
`kv_b` every step, as the reference does.
"""
from __future__ import annotations

import torch

from ..configs.base import MLAConfig, ModelConfig
from ..sharding.rules import gathered, write_row
from .layers import (ParamSpec, attend, chunked_attend, merge_heads, rms_norm,
                     rope, split_heads)


def mla_spec(cfg: ModelConfig) -> dict:
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "q_a": ParamSpec((d, m.q_lora_rank), ("embed", "lora")),
        "q_a_norm": ParamSpec((m.q_lora_rank,), ("lora",), "zeros"),
        "q_b": ParamSpec((m.q_lora_rank, H, qk), ("lora", "heads", None)),
        "kv_a": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                          ("embed", "lora")),
        "kv_a_norm": ParamSpec((m.kv_lora_rank,), ("lora",), "zeros"),
        "kv_b": ParamSpec((m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim),
                          ("lora", "heads", None)),
        "out": ParamSpec((H, m.v_head_dim, d), ("heads", None, "embed")),
    }


def _project(p, cfg: ModelConfig, x, positions):
    """x [B, T, d] -> q_nope [B, T, H, nope], q_rope [B, T, H, rope] (roped),
    kv_lat [B, T, r] (normed), k_rope [B, T, 1, rope] (roped)."""
    m = cfg.mla
    q_lat = rms_norm(torch.matmul(x, gathered(p["q_a"])), p["q_a_norm"],
                     cfg.norm_eps)
    q = split_heads(q_lat, p["q_b"])
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    kv = torch.matmul(x, gathered(p["kv_a"]))
    kv_lat = rms_norm(kv[..., :m.kv_lora_rank], p["kv_a_norm"], cfg.norm_eps)
    k_rope = rope(kv[..., None, m.kv_lora_rank:], positions, cfg.rope_theta)
    return q_nope, q_rope, kv_lat, k_rope


def _expand_kv(p, cfg: ModelConfig, kv_lat):
    """kv_lat [B, S, r] -> k_nope [B, S, H, nope], v [B, S, H, v]."""
    kvb = split_heads(kv_lat, p["kv_b"])
    return kvb[..., :cfg.mla.qk_nope_head_dim], kvb[..., cfg.mla.qk_nope_head_dim:]


def _qk(q_nope, q_rope, k_nope, k_rope):
    """q [B, T, H, nope + rope] and k [B, S, H, nope + rope], the rope key
    [B, S, rope] broadcast to every head."""
    B, S, H, _ = k_nope.shape
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, k_rope.shape[-1])
                   .to(k_nope.dtype)], -1)
    return q, k


def mla_attention(p, cfg: ModelConfig, x, positions, *, chunk=1024):
    """Full-sequence (prefill) MLA over x [B, T, d]. Returns (out [B, T, d],
    (kv_lat [B, T, r], k_rope [B, T, rope]))."""
    q_nope, q_rope, kv_lat, k_rope = _project(p, cfg, x, positions)
    k_nope, v = _expand_kv(p, cfg, kv_lat)
    q, k = _qk(q_nope, q_rope, k_nope, k_rope[:, :, 0])
    out = chunked_attend(q, k, v, positions, positions, chunk=chunk,
                         causal=True, window=None, softcap=cfg.attn_softcap)
    return merge_heads(out, p["out"]), (kv_lat, k_rope[:, :, 0])


def mla_decode(p, cfg: ModelConfig, x, pos, cache_lat, cache_rope, kv_valid):
    """One token against the latent cache: x [B, 1, d], pos [B, 1] (the
    same in every row), cache_lat [B, S, r], cache_rope [B, S, rope]. Writes
    this token's latent and rope key at pos, in place, and returns
    (out [B, 1, d], cache_lat, cache_rope), the same tensors."""
    q_nope, q_rope, kv_lat, k_rope = _project(p, cfg, x, pos)
    t = pos[:1, 0].long()
    cache_lat = write_row(cache_lat, 1, t, kv_lat.to(cache_lat.dtype))
    cache_rope = write_row(cache_rope, 1, t, k_rope[:, :, 0].to(cache_rope.dtype))
    k_nope, v = _expand_kv(p, cfg, cache_lat)
    q, k = _qk(q_nope, q_rope, k_nope, cache_rope)
    kpos = torch.arange(k.shape[1], device=x.device)[None]
    out = attend(q, k, v, pos, kpos, causal=True, window=None,
                 softcap=cfg.attn_softcap, kv_valid=kv_valid)
    return merge_heads(out, p["out"]), cache_lat, cache_rope
