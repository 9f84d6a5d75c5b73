"""Expert-parallel MoE over `torch.distributed` groups: the port of the
reference's `models/moe_ep.py`.

The reference runs under a ('data', 'model') mesh with `shard_map`: the
experts shard over 'data', each expert's hidden width over 'model'. Here
the ranks of `group` are the 'data' axis and those of `model_group` the
'model' axis:

  * each rank holds its own batch shard x [B_loc, S, d], the router
    (replicated), experts [p * E / P, (p + 1) * E / P) and, of each, the
    hidden columns [t * f / T, (t + 1) * f / T) (f = d_ff_expert, T the
    size of `model_group`, t this rank's place in it);
  * it routes its tokens locally at the per-shard capacity
    C = T_loc * k * capacity_factor / E, rounded *down* to a multiple of 8
    (at least 8), and dispatches them into xe [E, C, d];
  * one all-to-all over `group` sends each rank its E / P experts'
    buffers, the experts run on the [E / P, P * C, d] rows they received
    with their share of the hidden width, the partial outputs are summed
    over `model_group` (the reference's `psum`), and a second all-to-all
    returns them to the token owners;
  * the combine and the shared expert run locally.

The collectives are the functional ones (`_functional_collectives`), so
the function is differentiable, as the reference's is: an all-to-all
transposes to an all-to-all; the sum over `model_group` passes its
gradient through unchanged (every rank of the group goes on with the
same sum), and the gradient of the rows entering the experts is summed
over it, so that every rank holds the whole gradient of its x (and its
data shard's share of the router's). And `launch/cost_analysis.CostCounter` counts what they move. Under
a ('data', 'model') DTensor mesh (the dry run's expert-parallel cells)
the same body runs on each device's blocks (`on_blocks`) with the mesh's
'data' and 'model' groups, the inputs placed by the reference's specs.
"""
from __future__ import annotations

import functools

import torch

from ..configs.base import ModelConfig, MoEConfig
from ..sharding.rules import distributed, on_blocks
from .moe import (_combine_rows, _dispatch_rows, add_shared, experts,
                  moe_local, route_logits, router_logits)


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


def _local_width(w: torch.Tensor, dim: int, f: int, T: int, t: int) -> torch.Tensor:
    """This rank's f / T hidden columns of an expert weight along `dim`: w
    itself if it holds only those, else its slice of the whole width f."""
    if w.shape[dim] == f // T:
        return w
    if w.shape[dim] != f:
        raise ValueError(f"expert weights have a hidden width of "
                         f"{w.shape[dim]}; want {f} or this rank's {f // T}")
    return w.narrow(dim, t * (f // T), f // T)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [P, ...] with block q for rank q -> [P, ...] with block q from rank
    q, differentiable."""
    from torch.distributed import _functional_collectives as funcol

    return funcol.all_to_all_single_autograd(x.contiguous(), None, None, group)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))


class _SumOver(torch.autograd.Function):
    """The sum over a group in the forward; the gradient unchanged in the
    backward (every rank of the group goes on with the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGradOver(torch.autograd.Function):
    """x unchanged in the forward; its gradient summed over a group in the
    backward (each rank's is the share of its part of the hidden width),
    so every rank of the group holds the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.group), None


def _rank(group) -> tuple[int, int]:
    import torch.distributed as dist

    return dist.get_world_size(group), dist.get_rank(group)


def _ep_body(x, router, w_gate, w_up, w_down, *, e: MoEConfig, group,
             model_group):
    """The routed experts on one rank's blocks (the reference's `body`):
    x [B_loc, S, d] -> [B_loc, S, d], no shared expert."""
    E = e.num_experts
    P, rank = _rank(group)
    T, t = _rank(model_group) if model_group is not None else (1, 0)
    E_loc = E // P
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    r = route_logits(router_logits({"router": router}, xt), e,
                     _capacity(B * S, e))
    C = r.C
    if model_group is not None:
        xt = _SumGradOver.apply(xt, model_group)         # the width is split
    xe = _dispatch_rows(xt, r.topi, r.pos, r.keep, C, E).reshape(P, E_loc, C, d)
    xr = _all_to_all(xe, group)                          # [P_src, E_loc, C, d]
    xr = xr.permute(1, 0, 2, 3).reshape(E_loc, P * C, d)
    f = e.d_ff_expert
    wg, wu, wd = (_local_experts(w, E, P, rank) for w in (w_gate, w_up, w_down))
    y = experts(xr, _local_width(wg, 2, f, T, t), _local_width(wu, 2, f, T, t),
                _local_width(wd, 1, f, T, t))
    if model_group is not None:
        y = _SumOver.apply(y, model_group)               # the width was split
    y = y.reshape(E_loc, P, C, d).permute(1, 0, 2, 3)
    yb = _all_to_all(y, group)                           # [P_dst, E_loc, C, d]
    out = _combine_rows(yb.reshape(E, C, d), r.topi, r.topv, r.pos, r.keep, C)
    return out.to(x.dtype).reshape(B, S, d)


def _on_mesh(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """`moe_ffn_ep` on a DTensor x under a ('data', 'model') mesh: the
    inputs placed by the reference's specs (x over 'data', the router
    replicated, w_gate / w_up ('data', None, 'model'), w_down ('data',
    'model', None)), the body on each device's blocks with the mesh's
    groups, the output placed as x. Another mesh, or 'data' not dividing
    E, runs `moe_local`, as the reference falls back to its dense path."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    e = cfg.moe
    names = tuple(mesh.mesh_dim_names)
    if set(names) != {"data", "model"} or e.num_experts % mesh.size(
            names.index("data")):
        return moe_local(p, cfg, x)

    def on(data, model):
        out = [None, None]
        out[names.index("data")], out[names.index("model")] = data, model
        return out

    args = [x.redistribute(mesh, on(Shard(0), Replicate())),
            p["router"].redistribute(mesh, on(Replicate(), Replicate())),
            p["w_gate"].redistribute(mesh, on(Shard(0), Shard(2))),
            p["w_up"].redistribute(mesh, on(Shard(0), Shard(2))),
            p["w_down"].redistribute(mesh, on(Shard(0), Shard(1)))]
    body = functools.partial(_ep_body, e=e, group=mesh.get_group("data"),
                             model_group=mesh.get_group("model"))
    out = on_blocks(body, args[0], *args, grads={1: on(Partial(), Replicate())})
    return add_shared(p, cfg, x, out)


def moe_ffn_ep(p, cfg: ModelConfig, x: torch.Tensor, group=None,
               model_group=None) -> torch.Tensor:
    """`moe_ffn` with the experts sharded over `group` and, with a
    `model_group`, each expert's hidden width over it (x [B_loc, S, d],
    this rank's batch shard -> [B_loc, S, d]). The expert weights may be
    the whole stacks or this rank's share of them. Without a group, or
    when the group's size does not divide E, the MoE runs on this device
    (`moe.moe_local`). A DTensor x under a ('data', 'model') mesh runs on
    the mesh's groups (`_on_mesh`)."""
    if distributed(x):
        return _on_mesh(p, cfg, x)
    if group is None or cfg.moe.num_experts % _rank(group)[0]:
        return moe_local(p, cfg, x)
    out = _ep_body(x, p["router"], p["w_gate"], p["w_up"], p["w_down"],
                   e=cfg.moe, group=group, model_group=model_group)
    return add_shared(p, cfg, x, out)
