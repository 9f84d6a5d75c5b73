"""Expert-parallel MoE over a `torch.distributed` group: the port of the
reference's `models/moe_ep.py`.

The reference runs under a ('data', 'model') mesh with `shard_map`: the
experts shard over 'data', each expert's hidden width over 'model'. Here
the group's P ranks are the 'data' axis:

  * each rank holds its own batch shard x [B_loc, S, d], the router
    (replicated) and experts [p * E / P, (p + 1) * E / P);
  * it routes its tokens locally at the per-shard capacity
    C = T_loc * k * capacity_factor / E, rounded *down* to a multiple of 8
    (at least 8), and dispatches them into xe [E, C, d];
  * one `all_to_all_single` sends each rank its E / P experts' buffers,
    the experts run on the [E / P, P * C, d] rows they received, and a
    second one returns the outputs to the token owners;
  * the combine and the shared expert run locally.

The 'model' axis is 1 (one card per rank): the reference's split of the
expert width over it, and its `psum`, wait for the multi-card work of
ROADMAP Queue 1 #7b. No gradient: training is Queue 1 #12 (e).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, MoEConfig
from ..sharding.rules import distributed
from .moe import add_shared, combine, dispatch, experts, moe_local, route


def _capacity(tokens: int, e: MoEConfig) -> int:
    """Per-shard slots per expert (`moe_ep.py:66-67`): rounded down to a
    multiple of 8, at least 8 (the dense path rounds up)."""
    return max(8, int(tokens * e.top_k * e.capacity_factor / e.num_experts)
               // 8 * 8)


def _local_experts(w: torch.Tensor, E: int, P: int, rank: int) -> torch.Tensor:
    """This rank's E / P experts of w: w itself if it holds only those,
    else its slice of the whole stack [E, ...]."""
    E_loc = E // P
    if w.shape[0] == E_loc:
        return w
    if w.shape[0] != E:
        raise ValueError(f"expert weights have {w.shape[0]} experts; want "
                         f"{E} or this rank's {E_loc}")
    return w[rank * E_loc:(rank + 1) * E_loc]


def moe_ffn_ep(p, cfg: ModelConfig, x: torch.Tensor, group=None) -> torch.Tensor:
    """`moe_ffn` with the experts sharded over `group` (x [B_loc, S, d],
    this rank's batch shard -> [B_loc, S, d]). Without a group, or when
    the group's size does not divide E, the MoE runs on this device
    (`moe.moe_local`). A DTensor x (the dry run's expert-parallel cells)
    raises `NotImplementedError`: the mesh's 'data' dim as the group is
    ROADMAP Queue 1 #7b."""
    import torch.distributed as dist

    if distributed(x):
        raise NotImplementedError(
            "moe_ffn_ep takes a process group of its own and plain tensors; "
            "it cannot take a DTensor mesh's 'data' dim as its group "
            "(ROADMAP Queue 1 #7b)")
    e = cfg.moe
    E = e.num_experts
    if group is None:
        return moe_local(p, cfg, x)
    P = dist.get_world_size(group)
    if E % P:
        return moe_local(p, cfg, x)
    rank = dist.get_rank(group)
    E_loc = E // P
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    r = route(p, cfg, xt, _capacity(B * S, e))
    C = r.C
    xe = dispatch(xt, r, E).reshape(P, E_loc, C, d)     # contiguous
    xr = torch.empty_like(xe)
    dist.all_to_all_single(xr, xe, group=group)          # [P_src, E_loc, C, d]
    xr = xr.permute(1, 0, 2, 3).reshape(E_loc, P * C, d)
    y = experts(xr, *(_local_experts(p[k], E, P, rank)
                      for k in ("w_gate", "w_up", "w_down")))
    y = y.reshape(E_loc, P, C, d).permute(1, 0, 2, 3).contiguous()
    yb = torch.empty_like(y)
    dist.all_to_all_single(yb, y, group=group)           # [P_dst, E_loc, C, d]
    out = combine(yb.reshape(E, C, d), r).to(x.dtype).reshape(B, S, d)
    return add_shared(p, cfg, x, out)
