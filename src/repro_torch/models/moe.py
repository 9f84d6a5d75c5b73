"""Mixture-of-Experts FFN with capacity-based dispatch. The port of the
reference's `models/moe.py`.

Tokens are routed top-k over float32 gates; each expert takes at most C
tokens (the capacity), given in the flattened (token, k) order, and the
rest are dropped. The reference dispatches and combines with one-hot
[T, k, E, C] einsums, whose size grows with T^2 (6 GB in bf16 at
deepseek-v2's prefill of 2 x 4,096 tokens). The port computes the same
function on indices, in four stages that `chip_smoke.py` times one by one:

- `route`: the router's logits, the top-k (ties to the lower expert index,
  as `jax.lax.top_k`), the normalised weights, each (token, k)'s slot in
  its expert's buffer and whether it is kept;
- `dispatch`: each kept token row written to its slot of xe [E, C, d]
  (the kept targets are unique, so no accumulation);
- `experts`: (silu(xe W_g) * (xe W_u)) W_d as batched products over all
  E experts' C slots, as the reference keeps them;
- `combine`: each token's k rows of ye gathered and summed in float32, in
  k order, with their weights; no atomics, so a run repeats bitwise.

`moe_ffn_onehot` is the reference's one-hot arithmetic written literally
(`onehot_dispatch_combine`, and `dispatch_mask` puts a `Routing` in its
form): the oracle of the tests and of `chip_smoke.py`, off the serving
path.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
from ..sharding.rules import (block_index, constrain, gathered, on_blocks,
                              placements_for, split_on)
from .layers import ParamSpec, geglu


def moe_spec(cfg: ModelConfig) -> dict:
    e: MoEConfig = cfg.moe
    d = cfg.d_model
    spec = {
        "router": ParamSpec((d, e.num_experts), ("embed", "expert")),
        "w_gate": ParamSpec((e.num_experts, d, e.d_ff_expert),
                            ("expert", "embed", "mlp")),
        "w_up": ParamSpec((e.num_experts, d, e.d_ff_expert),
                          ("expert", "embed", "mlp")),
        "w_down": ParamSpec((e.num_experts, e.d_ff_expert, d),
                            ("expert", "mlp", "embed")),
    }
    if e.num_shared:
        spec |= {
            "shared_gate": ParamSpec((d, cfg.d_ff), ("embed", "mlp")),
            "shared_up": ParamSpec((d, cfg.d_ff), ("embed", "mlp")),
            "shared_down": ParamSpec((cfg.d_ff, d), ("mlp", "embed")),
        }
    return spec


def _capacity(tokens: int, e: MoEConfig) -> int:
    """Slots per expert: tokens * k * capacity_factor / E, rounded up to a
    multiple of 8, at least 8."""
    cap = int(tokens * e.top_k * e.capacity_factor / e.num_experts)
    return max(8, (cap + 7) // 8 * 8)


@dataclasses.dataclass(frozen=True)
class Routing:
    """Where each (token, k) goes: topi / topv [T, k] the experts (in
    descending gate order, ties to the lower index) and their normalised
    weights (float32), pos [T, k] the slot in the expert's buffer, keep
    [T, k] whether pos < C, and C."""
    topi: torch.Tensor
    topv: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    C: int


def router_logits(p, xt: torch.Tensor) -> torch.Tensor:
    """xt [T, d] @ router [d, E] in the params' dtype, then float32."""
    return torch.matmul(xt, gathered(p["router"])).to(torch.float32)


def route_logits(logits: torch.Tensor, e: MoEConfig, C: int) -> Routing:
    """The routing of float32 logits [T, E] at capacity C (the reference's
    `moe.py:58-68`)."""
    gates = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = vals[:, :e.top_k], idx[:, :e.top_k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # Slot of each (token, k): how many earlier (token, k), in the
    # flattened token-major order, chose the same expert. A stable sort
    # by expert keeps that order within each expert's run; the reference's
    # cumsum over [T * k, E] one-hots scans each expert's column
    # sequentially on the card.
    flat = topi.reshape(-1)
    order = torch.argsort(flat, stable=True)
    by_e = flat[order]
    start = torch.searchsorted(by_e, torch.arange(e.num_experts, device=flat.device))
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(flat.numel(), device=flat.device) - start[by_e]
    pos = pos.reshape(topi.shape)
    return Routing(topi, topv, pos, pos < C, C)


def route(p, cfg: ModelConfig, xt: torch.Tensor, C: int | None = None) -> Routing:
    """The routing of token rows xt [T, d]; C defaults to `_capacity(T)`.
    Under a mesh that splits the tokens (the data axes), each block of
    tokens is routed where it lives (`_route_blocks`); with the tokens
    whole, every device routes every token."""
    e = cfg.moe
    if C is None:
        C = _capacity(xt.shape[0], e)
    if split_on(xt, 0):
        return _route_blocks(constrain(router_logits(p, xt), "batch", None),
                             e, C)
    return route_logits(constrain(router_logits(p, xt), None, None), e, C)


def _route_blocks(logits, e: MoEConfig, C: int) -> Routing:
    """The routing of logits [T, E] whose rows are split over mesh dims (a
    DTensor), bitwise `route_logits` on the whole, ties included: each
    block routes its own rows, and a (token, k)'s slot is its slot within
    its block plus the (token, k) of the earlier blocks (the token-major
    order) that chose the same expert, from one gather of the blocks'
    per-expert counts [blocks, E]. Every field is split as the tokens."""
    from torch.distributed.tensor import Replicate

    mesh, E = logits.device_mesh, e.num_experts

    def local(lg):
        r = route_logits(lg, e, C)
        flat = r.topi.reshape(-1)
        counts = torch.zeros(E, dtype=flat.dtype, device=flat.device)
        counts.index_add_(0, flat, torch.ones_like(flat))
        return r.topi, r.topv, r.pos, counts[None]

    topi, topv, pos, counts = on_blocks(local, logits, logits, outs=4)
    table = counts.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    before = table[:block_index(mesh, logits.placements, 0)].sum(0)
    pos = on_blocks(lambda t, q: q + before[t], topi, topi, pos)
    return Routing(topi, topv, pos, pos < C, C)


def _experts_of_block(mesh, tokens: list, E: int):
    """How a buffer [E, C, d] of token rows split over `tokens`'
    placements lies on the mesh: (its placements, Partial over the dims
    that split the tokens and Shard(0) over those the rules split the
    experts over; this device's first expert; its expert count)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    rule = placements_for(mesh, ("expert", None, None), (E, 1, 1))
    place = [Partial() if t.is_shard(0) else Shard(0) if x.is_shard(0)
             else Replicate() for t, x in zip(tokens, rule)]
    n = E
    for i, pl in enumerate(place):
        if pl.is_shard(0):
            n //= mesh.size(i)
    return place, block_index(mesh, place, 0) * n, n


def _dispatch_rows(xt, topi, pos, keep, C: int, E: int, span=None):
    """xe [n, C, d]: the kept (token, k) rows of experts [lo, lo + n)
    (`span`; all E without one) at their slots, zeros elsewhere. Dropped
    rows go to one trash row past the n * C slots (no mask, so no host
    sync); the kept targets are unique."""
    T, d = xt.shape
    k = topi.shape[1]
    lo, n = span or (0, E)
    mine = keep if span is None else keep & (topi >= lo) & (topi < lo + n)
    slot = (topi if span is None else topi - lo) * C + pos
    buf = xt.new_zeros((n * C + 1, d))
    dest = torch.where(mine, slot, n * C).reshape(T * k)
    buf[dest] = xt[:, None].expand(T, k, d).reshape(T * k, d)
    return buf[:n * C].view(n, C, d)


def dispatch(xt: torch.Tensor, r: Routing, E: int) -> torch.Tensor:
    """xe [E, C, d] in xt's dtype: each kept (token, k)'s row at its slot,
    zeros in the empty slots. Under a mesh that splits the tokens, each
    device writes its own tokens into its experts' slots, and the blocks'
    buffers are summed over the token axes, split there along the slots
    (one reduce-scatter; the slots of a block's tokens are its own)."""
    if not split_on(xt, 0):
        return _dispatch_rows(xt, r.topi, r.pos, r.keep, r.C, E)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = xt.device_mesh
    place, lo, n = _experts_of_block(mesh, list(xt.placements), E)
    blocks = 1
    for i, pl in enumerate(place):
        if pl.is_partial():
            blocks *= mesh.size(i)
    xe = on_blocks(lambda x, t, q, kp: _dispatch_rows(x, t, q, kp, r.C, E,
                                                      (lo, n)),
                   place, xt, r.topi, r.pos, r.keep,
                   grads={0: [Partial() if pl.is_shard(0) else p for pl, p
                              in zip(place, xt.placements)]})
    split = Shard(1) if r.C % blocks == 0 else Replicate()
    return xe.redistribute(mesh, [split if pl.is_partial() else pl
                                  for pl in place])


def experts(xe: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """ye [E, C, d] = (silu(xe W_g) * (xe W_u)) W_d, batched over E."""
    g = torch.bmm(xe, gathered(w_gate))
    u = torch.bmm(xe, gathered(w_up))
    return torch.bmm(F.silu(g) * u, gathered(w_down))


def _combine_rows(ye, topi, topv, pos, keep, C: int, span=None):
    """yt [T, d] float32 from the rows ye [n, C, d] of experts [lo, lo + n)
    (`span`; all of them without one): sum over k, in k order, of topv *
    keep times the row at the (token, k)'s slot, 0 for other experts."""
    n, _, d = ye.shape
    flat = ye.reshape(n * C, d)
    mine = keep if span is None else \
        keep & (topi >= span[0]) & (topi < span[0] + span[1])
    slot = torch.where(mine, (topi if span is None else topi - span[0]) * C
                       + pos, 0)
    w = topv * mine
    yt = None
    for j in range(topi.shape[1]):
        term = flat[slot[:, j]].to(torch.float32) * w[:, j, None]
        yt = term if yt is None else yt + term
    return yt


def combine(ye: torch.Tensor, r: Routing) -> torch.Tensor:
    """yt [T, d] float32: sum over k, in k order, of topv * keep times the
    row of ye at the (token, k)'s slot. Under a mesh that splits the
    tokens, each device gathers its experts' slots over the token axes
    and sums its tokens' rows of them; the experts' partial sums are
    added over the mesh (float32, before any cast), as are, in the
    backward, the partial gradients of the weights topv."""
    if not split_on(r.topi, 0):
        return _combine_rows(ye, r.topi, r.topv, r.pos, r.keep, r.C)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = ye.device_mesh
    tokens = list(r.topi.placements)
    place, lo, n = _experts_of_block(mesh, tokens, ye.shape[0])
    held = [Shard(0) if pl.is_shard(0) else Replicate() for pl in place]
    out = [Shard(0) if t.is_shard(0) else Partial() if pl.is_shard(0)
           else Replicate() for t, pl in zip(tokens, place)]
    yt = on_blocks(lambda y, t, v, q, kp: _combine_rows(y, t, v, q, kp, r.C,
                                                        (lo, n)),
                   out, ye.redistribute(mesh, held), r.topi, r.topv, r.pos,
                   r.keep, grads={0: [Partial() if t.is_shard(0) else h
                                      for t, h in zip(tokens, held)],
                                  2: [Partial() if pl.is_shard(0) else t
                                      for t, pl in zip(tokens, place)]})
    return yt.redistribute(mesh, [Replicate() if pl.is_partial() else pl
                                  for pl in out])


def add_shared(p, cfg: ModelConfig, x, out):
    """Add the shared expert (hidden width cfg.d_ff, one fused GeGLU)."""
    if cfg.moe.num_shared:
        out = out + geglu(x, p["shared_gate"], p["shared_up"], p["shared_down"],
                          act=cfg.act)
    return out


def moe_local(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The MoE FFN on one device: x [B, S, d] -> [B, S, d]."""
    B, S, d = x.shape
    xt = constrain(x.reshape(B * S, d), "batch", None)
    r = route(p, cfg, xt)
    E = cfg.moe.num_experts
    ye = experts(dispatch(xt, r, E), p["w_gate"], p["w_up"], p["w_down"])
    out = combine(ye, r).to(x.dtype).reshape(B, S, d)
    return add_shared(p, cfg, x, out)


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor, group=None,
            model_group=None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]. With `cfg.moe.ep` set, the experts run
    sharded over `group`, their hidden width over `model_group`
    (`moe_ep.moe_ffn_ep`, which falls back to this device's `moe_local`
    without a group)."""
    if cfg.moe.ep:
        from .moe_ep import moe_ffn_ep
        return moe_ffn_ep(p, cfg, x, group=group, model_group=model_group)
    return moe_local(p, cfg, x)


def dispatch_mask(r: Routing, E: int) -> torch.Tensor:
    """The routing as the reference's dispatch [T, E, C] bool: True where
    token t sits in slot c of expert e."""
    T, k = r.topi.shape
    out = torch.zeros((T, E, r.C + 1), dtype=torch.bool, device=r.topi.device)
    tok = torch.arange(T, device=r.topi.device)[:, None].expand(T, k)
    out[tok, r.topi, torch.where(r.keep, r.pos, r.C)] = True
    return out[..., :r.C]


def onehot_dispatch_combine(xt, logits, e: MoEConfig, C: int):
    """The reference's one-hot routing (`moe.py:58-74`, `moe_ep.py:31-47`)
    written literally: top-k by a stable argsort (ties to the lower index),
    the one-hot position cumsum, the [T, k, E, C + 1] slot one-hots.
    Returns dispatch [T, E, C] in xt's dtype and combine [T, E, C]
    float32."""
    T = xt.shape[0]
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    topi = torch.argsort(-gates, dim=-1, stable=True)[:, :e.top_k]
    topv = gates.gather(1, topi)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(topi, e.num_experts)                          # [T,k,E]
    flat = onehot.reshape(T * e.top_k, e.num_experts)
    pos = torch.cumsum(flat, dim=0) * flat - 1
    pos = pos.reshape(T, e.top_k, e.num_experts)
    keep = (pos < C) & (pos >= 0)
    slot = F.one_hot(torch.where(keep, pos, C), C + 1).to(xt.dtype)[..., :C]
    dispatch_ = (slot * keep[..., None].to(xt.dtype)).sum(1)
    combine_ = (slot * (topv[..., None] * keep.to(torch.float32))[..., None]
                ).sum(1).to(torch.float32)
    return dispatch_, combine_


def moe_ffn_onehot(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The reference's `moe_ffn` (`moe.py:54-88`) in its own arithmetic:
    `onehot_dispatch_combine` on the router's logits (`router_logits`, the
    index form's, so both route the same numbers), then the dispatch,
    expert and combine einsums. The plain version the index form is held
    against; its tensors grow with T^2, so it is for a few hundred
    tokens."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    logits = router_logits(p, xt)
    dispatch_, combine_ = onehot_dispatch_combine(xt, logits, cfg.moe,
                                                  _capacity(T, cfg.moe))
    xe = torch.einsum("td,tec->ecd", xt, dispatch_)
    g = torch.einsum("ecd,edf->ecf", xe, p["w_gate"])
    u = torch.einsum("ecd,edf->ecf", xe, p["w_up"])
    ye = torch.einsum("ecf,efd->ecd", F.silu(g) * u, p["w_down"])
    yt = torch.einsum("ecd,tec->td", ye.to(torch.float32), combine_)
    return add_shared(p, cfg, x, yt.to(x.dtype).reshape(B, S, d))


def aux_load_balance_loss(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * P_e (f_e the share of
    tokens whose top-1 is e, ties to the lower index as `jnp.argmax`; P_e
    the mean gate)."""
    e = cfg.moe
    xt = x.reshape(-1, x.shape[-1])
    gates = torch.softmax(router_logits(p, xt), dim=-1)
    top1 = torch.argmax(gates, dim=-1)
    f = F.one_hot(top1, e.num_experts).to(torch.float32).mean(0)
    P = gates.mean(0)
    return e.num_experts * torch.sum(f * P)
