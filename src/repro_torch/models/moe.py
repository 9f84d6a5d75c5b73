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
from ..sharding.rules import constrain, gathered
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
    """The routing of token rows xt [T, d]; C defaults to `_capacity(T)`."""
    e = cfg.moe
    if C is None:
        C = _capacity(xt.shape[0], e)
    # Under a mesh the routing runs on every token on every device: a
    # token's slot depends on every earlier token's choice.
    return route_logits(constrain(router_logits(p, xt), None, None), e, C)


def _slots(r: Routing) -> torch.Tensor:
    """Flat slot e * C + pos of each (token, k) [T, k]."""
    return r.topi * r.C + r.pos


def dispatch(xt: torch.Tensor, r: Routing, E: int) -> torch.Tensor:
    """xe [E, C, d] in xt's dtype: each kept (token, k)'s row at its slot,
    zeros in the empty slots. The dropped rows go to one trash row past
    the E * C slots (no mask, so no host sync); the kept targets are
    unique."""
    T, d = xt.shape
    k = r.topi.shape[1]
    buf = xt.new_zeros((E * r.C + 1, d))
    dest = torch.where(r.keep, _slots(r), E * r.C).reshape(T * k)
    buf[dest] = xt[:, None].expand(T, k, d).reshape(T * k, d)
    return buf[:E * r.C].view(E, r.C, d)


def experts(xe: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """ye [E, C, d] = (silu(xe W_g) * (xe W_u)) W_d, batched over E."""
    g = torch.bmm(xe, gathered(w_gate))
    u = torch.bmm(xe, gathered(w_up))
    return torch.bmm(F.silu(g) * u, gathered(w_down))


def combine(ye: torch.Tensor, r: Routing) -> torch.Tensor:
    """yt [T, d] float32: sum over k, in k order, of topv * keep times the
    row of ye at the (token, k)'s slot."""
    E, C, d = ye.shape
    flat = ye.reshape(E * C, d)
    slot = torch.where(r.keep, _slots(r), 0)
    w = r.topv * r.keep
    yt = None
    for j in range(r.topi.shape[1]):
        term = flat[slot[:, j]].to(torch.float32) * w[:, j, None]
        yt = term if yt is None else yt + term
    return yt


def add_shared(p, cfg: ModelConfig, x, out):
    """Add the shared expert (hidden width cfg.d_ff, one fused GeGLU)."""
    if cfg.moe.num_shared:
        out = out + geglu(x, p["shared_gate"], p["shared_up"], p["shared_down"],
                          act=cfg.act)
    return out


def moe_local(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The MoE FFN on one device: x [B, S, d] -> [B, S, d]."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    r = route(p, cfg, xt)
    E = cfg.moe.num_experts
    ye = experts(dispatch(xt, r, E), p["w_gate"], p["w_up"], p["w_down"])
    out = combine(ye, r).to(x.dtype).reshape(B, S, d)
    return add_shared(p, cfg, x, out)


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor, group=None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]. With `cfg.moe.ep` set, the experts run
    sharded over `group` (`moe_ep.moe_ffn_ep`, which falls back to this
    device's `moe_local` without a group)."""
    if cfg.moe.ep:
        from .moe_ep import moe_ffn_ep
        return moe_ffn_ep(p, cfg, x, group=group)
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
