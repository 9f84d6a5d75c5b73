"""Model assembly: param specs, the layer stacks and the full-sequence
forward for every family (dense, MoE, audio, vision, "ssm", hybrid). The
port of the reference's `models/transformer.py`.

The reference scans over stacked params (`jax.lax.scan`); here each stack
is a Python loop over the layer axis of the same stacked tensors, and the
per-layer window is a Python int (-1 = global). A stack of llama4's
dense / MoE interleave holds two stacked trees, "dense" and "moe", one
layer of each per unit. The reference's sharding calls stand where it has
them (`sharding.rules.constrain`, `tp_size`): they act on DTensors under
a mesh (the dry run) and return their input as it is otherwise.
`remat=True` recomputes each block (a layer, or llama4's unit of two) in
the backward, as the reference's `jax.checkpoint` does; `loss_fn` is the
training loss.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from ..sharding.rules import (constrain, distributed, gathered, place,
                              reduce_grad, split_on, tp_size, write_row)
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (ParamSpec, attend, chunked_attend, cross_entropy,
                     embed_rows, geglu, merge_heads, remat as remat_call,
                     rms_norm, rope, split_heads)


# ---------------- param specs ----------------

def attn_spec(cfg: ModelConfig) -> dict:
    d, H, G, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "q": ParamSpec((d, H, Dh), ("embed", "heads", None)),
        "k": ParamSpec((d, G, Dh), ("embed", "kv_heads", None)),
        "v": ParamSpec((d, G, Dh), ("embed", "kv_heads", None)),
        "o": ParamSpec((H, Dh, d), ("heads", None, "embed")),
    }


def dense_ffn_spec(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("embed", "mlp")),
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }


def block_spec(cfg: ModelConfig, *, moe_layer: bool) -> dict:
    return {"attn_norm": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
            "ffn_norm": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
            "attn": mla_mod.mla_spec(cfg) if cfg.mla else attn_spec(cfg),
            "ffn": moe_mod.moe_spec(cfg) if moe_layer else dense_ffn_spec(cfg)}


def ssm_block_spec(cfg: ModelConfig) -> dict:
    return {"norm": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
            "mixer": ssm_mod.ssm_spec(cfg)}


def _stacked(spec, L: int):
    if isinstance(spec, ParamSpec):
        return ParamSpec((L,) + spec.shape, ("layers",) + spec.axes, spec.init)
    return {k: _stacked(v, L) for k, v in spec.items()}


def moe_interleave(cfg: ModelConfig) -> int:
    """Layers per stack unit (llama4: dense / MoE alternation -> 2)."""
    return cfg.moe_every if cfg.moe else 1


def model_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    spec: dict = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed")),
        "final_norm": ParamSpec((d,), ("embed",), "zeros"),
    }
    if cfg.family in ("ssm", "hybrid"):
        spec["layers"] = _stacked(ssm_block_spec(cfg), cfg.n_layers)
        if cfg.family == "hybrid" and cfg.attn_every:
            spec["shared_attn"] = block_spec(cfg, moe_layer=False)
    else:
        unit = moe_interleave(cfg)
        n_units = cfg.n_layers // unit
        if unit == 1:
            spec["layers"] = _stacked(block_spec(cfg, moe_layer=bool(cfg.moe)),
                                      n_units)
        else:
            spec["layers"] = {
                "dense": _stacked(block_spec(cfg, moe_layer=False), n_units),
                "moe": _stacked(block_spec(cfg, moe_layer=True), n_units),
            }
    if cfg.frontend == "vision":
        spec["patch_proj"] = ParamSpec((d, d), ("embed", None))
    if cfg.frontend == "audio":
        spec["frame_proj"] = ParamSpec((d, d), ("embed", None))
    return spec


# ---------------- attention block ----------------

def windows(cfg: ModelConfig) -> list[int]:
    """Each layer's attention window: cfg.window for a local layer, -1 for
    a global one (the reference's `_window_arr`)."""
    return [cfg.window if kind == "local" else -1 for kind in cfg.layer_kinds()]


def gqa_forward(p, cfg: ModelConfig, x, positions, window: int, *, chunk=1024):
    """Prefill attention over x [B, T, d]. window: -1 = global. Returns
    (out [B, T, d], (k, v)).

    Under a mesh, attention is head-parallel when both head counts divide
    the tensor axis, as in the reference. Otherwise (ragged-head archs:
    llama4's 40 heads, internvl2's 14) it is query-sequence-parallel: the
    query positions, with their projections in and out, split over the
    tensor axis and the few kv heads whole on every device. The
    reference splits the keys' sequence instead (`act_seq_tp` on k / v),
    but XLA's FLOP count of internvl2's train step splits the query and
    output projections too, which that split leaves whole; and DTensor,
    which has no softmax over a split dim, would gather the score tiles."""
    tp = tp_size()
    heads = cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0
    xq, qpos = x, positions
    if not heads:
        xq = constrain(x, "batch", "act_seq_tp", None)
        qpos = constrain(positions, "batch", "act_seq_tp")
    q = rope(split_heads(xq, p["q"], seq=not heads), qpos, cfg.rope_theta)
    k = rope(split_heads(x, p["k"]), positions, cfg.rope_theta)
    v = split_heads(x, p["v"])
    if heads:
        q = constrain(q, "batch", None, "act_heads", None)
        k = constrain(k, "batch", None, "act_kv", None)
        v = constrain(v, "batch", None, "act_kv", None)
    out = chunked_attend(q, k, v, qpos, positions, chunk=chunk,
                         causal=not cfg.encoder_only, window=window,
                         softcap=cfg.attn_softcap)
    return merge_heads(out, p["o"]), (k, v)


def gqa_decode(p, cfg: ModelConfig, x, pos, cache_k, cache_v, window: int):
    """x [B, 1, d]; cache_k / v [B, Smax, G, Dh]; pos [B, 1] the current
    position (the same in every row). Writes this token's k / v into the
    caches at pos, in place, and returns (out [B, 1, d], cache_k, cache_v),
    the same tensors."""
    q = rope(split_heads(x, p["q"]), pos, cfg.rope_theta)
    k = rope(split_heads(x, p["k"]), pos, cfg.rope_theta)
    v = split_heads(x, p["v"])
    if split_on(cache_k, 1):
        # A cache split along its sequence (kv heads the tensor axis does
        # not divide): every device scores its keys with every head.
        q = constrain(q, "batch", None, None, None)
    t = pos[:1, 0].long()
    cache_k = write_row(cache_k, 1, t, k.to(cache_k.dtype))
    cache_v = write_row(cache_v, 1, t, v.to(cache_v.dtype))
    kpos = torch.arange(cache_k.shape[1], device=x.device)[None]
    out = attend(q, cache_k, cache_v, pos, kpos, causal=True, window=window,
                 softcap=cfg.attn_softcap, kv_valid=kpos <= t)
    return merge_heads(out, p["o"]), cache_k, cache_v


def _ffn(p, cfg: ModelConfig, x, *, moe_layer: bool):
    if moe_layer:
        return moe_mod.moe_ffn(p, cfg, x)
    return geglu(x, p["w_gate"], p["w_up"], p["w_down"], act=cfg.act)


def block_forward(p, cfg, x, positions, window: int, *, moe_layer=False,
                  chunk=1024):
    h = reduce_grad(rms_norm(x, p["attn_norm"], cfg.norm_eps))
    if cfg.mla:
        attn_out, kv = mla_mod.mla_attention(p["attn"], cfg, h, positions,
                                             chunk=chunk)
    else:
        attn_out, kv = gqa_forward(p["attn"], cfg, h, positions, window,
                                   chunk=chunk)
    x = x + attn_out
    h = reduce_grad(rms_norm(x, p["ffn_norm"], cfg.norm_eps))
    x = x + _ffn(p["ffn"], cfg, h, moe_layer=moe_layer)
    return constrain(x, "batch", None, None), kv


def block_decode(p, cfg, x, pos, cache: dict, window: int, *, moe_layer=False):
    """One token through a block; the cache ({"k", "v"}, or MLA's {"lat",
    "rope"}) is written in place."""
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    if cfg.mla:
        kv_valid = torch.arange(cache["lat"].shape[1], device=x.device)[None] \
            <= pos[:1, 0].long()
        attn_out, lat, rp = mla_mod.mla_decode(p["attn"], cfg, h, pos,
                                               cache["lat"], cache["rope"],
                                               kv_valid=kv_valid)
        new_cache = {"lat": lat, "rope": rp}
    else:
        attn_out, ck, cv = gqa_decode(p["attn"], cfg, h, pos, cache["k"],
                                      cache["v"], window)
        new_cache = {"k": ck, "v": cv}
    x = x + attn_out.to(x.dtype)       # cache dtype may differ (f32 serving)
    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    return x + _ffn(p["ffn"], cfg, h, moe_layer=moe_layer), new_cache


# ---------------- stacks ----------------

def layer(tree, i: int) -> dict:
    """Layer i of a stacked param tree (views, no copies)."""
    return {k: layer(tree[k], i) if not isinstance(tree[k], torch.Tensor)
            else tree[k][i] for k in tree.keys()}


def unstacked(tree) -> list[dict]:
    """Every layer of a stacked param tree, as `layer` gives them, from one
    `unbind` per leaf: the backward then writes each stacked leaf's
    gradient once, where a view per layer would add a zero-filled
    full-size gradient per layer."""
    flat = {k: torch.unbind(tree[k]) if isinstance(tree[k], torch.Tensor)
            else unstacked(tree[k]) for k in tree.keys()}
    n = len(next(iter(flat.values())))
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def attn_layers(params, cfg: ModelConfig):
    """Each attention layer in order, as (layer params, window, moe_layer,
    cache prefix, index in its stack): one stack, or llama4's units of a
    dense then a MoE layer, whose caches are "dense_*" / "moe_*" (the
    reference's windows at offsets 0 / 1, stride `moe_interleave`)."""
    unit, w = moe_interleave(cfg), windows(cfg)
    if unit == 1:
        lps = unstacked(params["layers"])
        for i in range(cfg.n_layers):
            yield lps[i], w[i], bool(cfg.moe), "", i
        return
    parts = {part: unstacked(params["layers"][part]) for part in ("dense", "moe")}
    for i in range(cfg.n_layers // unit):
        for off, part in enumerate(("dense", "moe")):
            yield (parts[part][i], w[i * unit + off], part == "moe",
                   f"{part}_", i)


def _attn_stack(params, cfg: ModelConfig, x, positions, *, remat=False,
                chunk=1024):
    """The attention stack; with `remat` each unit (one block, or llama4's
    dense + MoE pair) is recomputed in the backward. The reference carries
    the stack in float32 under remat; a bf16 block output cast to float32
    and back is exact, so that changes no value and is not copied."""
    def unit(x, *blocks):
        for lp, w, moe_layer in blocks:
            x, _ = block_forward(lp, cfg, x, positions, w, moe_layer=moe_layer,
                                 chunk=chunk)
        return x

    blocks = [(lp, w, moe_layer) for lp, w, moe_layer, _, _
              in attn_layers(params, cfg)]
    per = moe_interleave(cfg)
    for a in range(0, len(blocks), per):
        x = remat_call(unit, x, *blocks[a:a + per]) if remat \
            else unit(x, *blocks[a:a + per])
    return x


def hybrid_segments(cfg: ModelConfig) -> list[tuple[int, int]]:
    """Layer ranges between shared-attention insertion points (zamba2):
    the shared block runs *before* each segment of attn_every ssm layers.
    One segment for the "ssm" family."""
    if cfg.family != "hybrid" or not cfg.attn_every:
        return [(0, cfg.n_layers)]
    return [(s, min(s + cfg.attn_every, cfg.n_layers))
            for s in range(0, cfg.n_layers, cfg.attn_every)]


def _ssm_stack(params, cfg: ModelConfig, x, positions, *, remat=False,
               chunk=1024, use_kernel: bool = True):
    """The "ssm" / hybrid stack; with `remat` each SSM layer is recomputed
    in the backward (the shared attention block is not, as in the
    reference; its chunked attention recomputes each chunk)."""
    use_shared = cfg.family == "hybrid" and cfg.attn_every

    def ssm_layer(x, lp):
        hn = rms_norm(x, lp["norm"], cfg.norm_eps)
        out, _ = ssm_mod.mamba2_block(lp["mixer"], cfg, hn,
                                      use_kernel=use_kernel)
        return x + out

    lps = unstacked(params["layers"])
    for a, b in hybrid_segments(cfg):
        if use_shared:
            x, _ = block_forward(params["shared_attn"], cfg, x, positions, -1,
                                 chunk=chunk)
        for i in range(a, b):
            x = remat_call(ssm_layer, x, lps[i]) if remat else ssm_layer(x, lps[i])
    return x


def embed_scale(cfg: ModelConfig) -> float:
    """sqrt(d_model) rounded to bf16, as the reference scales embeddings
    (`transformer.py:276`), held as a Python float: the product keeps the
    embeddings' dtype, as JAX's promotion does."""
    return float(torch.tensor(math.sqrt(cfg.d_model)).to(torch.bfloat16))


def _embed_inputs(params, cfg: ModelConfig, batch: dict):
    """The stack's input [B, S, d]: audio frames through `frame_proj`,
    vision patches through `patch_proj` followed by the scaled text
    embeddings, or the scaled token embeddings."""
    if cfg.frontend == "audio":
        x = torch.matmul(batch["frames"], gathered(params["frame_proj"]))
    else:
        x = embed_rows(gathered(params["embed"]), batch["tokens"]) \
            * embed_scale(cfg)
        if cfg.frontend == "vision":
            pe = torch.matmul(batch["patches"], gathered(params["patch_proj"]))
            x = torch.cat([pe, x.to(pe.dtype)], dim=1)
    return constrain(x, "batch", None, None)


def forward_hidden(params, cfg: ModelConfig, batch: dict, *, remat=False,
                   chunk=1024, use_kernel: bool = True):
    """Embed + stack + final norm -> hidden [B, S, d] (no logits).
    `use_kernel` picks K6 / K7 or their plain versions in the SSM blocks;
    `remat` recomputes each block in the backward."""
    x = _embed_inputs(params, cfg, batch)
    B, S = x.shape[:2]
    positions = place(torch.arange(S, device=x.device).expand(B, S),
                      "batch", None)
    if cfg.family in ("ssm", "hybrid"):
        x = _ssm_stack(params, cfg, x, positions, remat=remat, chunk=chunk,
                       use_kernel=use_kernel)
    else:
        x = _attn_stack(params, cfg, x, positions, remat=remat, chunk=chunk)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def logits_of(params, x) -> torch.Tensor:
    """Tied-embedding logits [..., vocab] in float32 (the product runs in
    the params' dtype, then casts, as the reference's einsum does)."""
    return torch.matmul(x, gathered(params["embed"]).transpose(0, 1)
                        ).to(torch.float32)


def forward(params, cfg: ModelConfig, batch: dict, *, chunk=1024,
            use_kernel: bool = True):
    """Full-sequence forward -> logits [B, S, vocab] (fp32). Like the
    reference's, these logits carry no `logit_softcap`; `decode_step`'s
    do."""
    logits = logits_of(params, forward_hidden(params, cfg, batch, chunk=chunk,
                                              use_kernel=use_kernel))
    return constrain(logits, "batch", None, "vocab")


def _vocab_whole_over_model(embed) -> bool:
    """Whether `embed` is a DTensor under a mesh whose 'model' axis (of
    more than one device) leaves the vocabulary whole: a vocabulary the
    axis does not divide (internvl2's 151,655 over 16)."""
    if not distributed(embed) or tp_size() == 1:
        return False
    m = embed.device_mesh.mesh_dim_names.index("model")
    return not embed.placements[m].is_shard(0)


def _ce_rows_over_model(x, embed, labels, vocab, softcap, *, rows=512):
    """`_chunked_ce` under a mesh whose 'model' axis leaves the vocabulary
    whole: each model rank takes its share of its data shard's rows
    (positions), in chunks of `rows` recomputed in the backward, and the
    ranks' sums are added over the mesh and divided by the row count; so
    no two ranks compute the same logit, as XLA splits them. The same
    mean, summed in another order."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = embed.device_mesh
    m = mesh.mesh_dim_names.index("model")
    x = constrain(x, "batch", None, None)
    labels = constrain(labels, "batch", None)
    B, S, d = x.shape
    everywhere = [Partial()] * mesh.ndim
    xl = x.to_local(grad_placements=[Partial() if i == m else p
                                     for i, p in enumerate(x.placements)])
    el = gathered(embed).to_local(grad_placements=everywhere)
    xl, ll = xl.reshape(-1, d), labels.to_local().reshape(-1)
    n, T, t = xl.shape[0], mesh.size(m), mesh.get_local_rank(m)
    lo, hi = n * t // T, n * (t + 1) // T

    def body(xc, lc):
        return cross_entropy(torch.matmul(xc, el.transpose(0, 1)), lc, vocab,
                             softcap, reduction="sum")

    tot = torch.zeros((), dtype=torch.float32, device=xl.device)
    for a in range(lo, hi, rows):
        b = min(a + rows, hi)
        tot = tot + remat_call(body, xl[a:b], ll[a:b])
    # One sum a device, [devices] split over every mesh dim, summed.
    tot = DTensor.from_local(tot[None], mesh, [Shard(0)] * mesh.ndim,
                             run_check=False).sum()
    return tot.redistribute(mesh, [Replicate()] * mesh.ndim) / (B * S)


def _chunked_ce(x, embed, labels, vocab, softcap, *, seq_chunk=512):
    """The cross-entropy over sequence chunks of `seq_chunk` positions (one
    chunk when S is not a multiple of it, as in the reference), each chunk
    recomputed in the backward, so that no chunk's float32 logits are
    kept; the mean of the chunks' means. Under a mesh that leaves the
    vocabulary whole over 'model', `_ce_rows_over_model`."""
    if _vocab_whole_over_model(embed):
        return _ce_rows_over_model(x, embed, labels, vocab, softcap,
                                   rows=seq_chunk)
    B, S, d = x.shape
    if S % seq_chunk:
        seq_chunk = S                      # ragged: fall back to one chunk
    n = S // seq_chunk
    embed = gathered(embed)

    def body(xc, lc):
        return cross_entropy(torch.matmul(xc, embed.transpose(0, 1)), lc,
                             vocab, softcap)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in range(0, S, seq_chunk):
        tot = tot + remat_call(body, x[:, a:a + seq_chunk],
                               labels[:, a:a + seq_chunk])
    return tot / n


def loss_fn(params, cfg: ModelConfig, batch: dict, *, remat=True, chunk=1024):
    """The training loss: next-token cross-entropy (the tokens themselves
    for encoder-only and audio models), over the text positions only for
    vision models. Runs the SSM blocks on the plain chunked SSD
    (`use_kernel=False`), as the reference trains: the kernels take no
    gradient."""
    x = forward_hidden(params, cfg, batch, remat=remat, chunk=chunk,
                       use_kernel=False)
    labels = batch["labels"]
    if cfg.frontend == "vision":            # loss on text positions only
        x = x[:, cfg.num_patches:]
    if not cfg.encoder_only and cfg.frontend != "audio":
        x, labels = x[:, :-1], labels[:, 1:]
    return _chunked_ce(x, params["embed"], labels, cfg.vocab,
                       cfg.logit_softcap)
