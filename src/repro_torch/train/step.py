"""The train step: loss, gradient and AdamW update, with optional gradient
accumulation over microbatches. The port of the reference's
`train/step.py`.

The loss is `transformer.loss_fn` with remat on (each block recomputed in
the backward). Gradients come from `torch.autograd.grad` on the params'
leaves, which must require grad (`Params.trainable(True)`); a bf16 leaf
gets a bf16 gradient, as under `jax.grad`. With `accum` microbatches the
losses and gradients are summed into float32 accumulators, microbatch
after microbatch, then divided by `accum` (the reference's `lax.scan`).
The update is `optimizer.apply_updates`, in place.
"""
from __future__ import annotations

import functools

import torch

from ..configs.base import ModelConfig
from ..models import transformer as tfm
from ..models.layers import named_leaves, nest
from ..sharding.rules import constrain
from .optimizer import AdamWConfig, apply_updates

F32 = torch.float32


def loss_and_grads(params, cfg: ModelConfig, batch: dict, *, accum: int = 1,
                   chunk: int = 1024) -> tuple[torch.Tensor, dict]:
    """(loss, grads) of `loss_fn` over `batch` (leaves with a leading
    global batch axis), split into `accum` microbatches of consecutive
    rows. grads: nested dicts under the params' keys; float32 when
    accum > 1, else each leaf's dtype."""
    named = list(named_leaves(params))
    paths, leaves = [p for p, _ in named], [t for _, t in named]
    frozen = [".".join(p) for p, t in named if not t.requires_grad]
    if frozen:
        raise ValueError(f"params must be trainable (Params.trainable(True)); "
                         f"{frozen[:3]} do not require grad")

    def one(mb):
        loss = tfm.loss_fn(params, cfg, mb, remat=True, chunk=chunk)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    if accum == 1:
        loss, grads = one(batch)
        return loss, nest(zip(paths, grads))
    rows = next(iter(batch.values())).shape[0]
    if accum < 1 or rows % accum:
        raise ValueError(f"accum={accum} must divide the batch of {rows} rows")
    b = rows // accum
    loss = torch.zeros((), dtype=F32, device=leaves[0].device)
    acc = [torch.zeros_like(t, dtype=F32) for t in leaves]   # placed as t
    for i in range(accum):
        l, g = one({k: constrain(v[i * b:(i + 1) * b], "batch",
                                 *[None] * (v.dim() - 1))
                    for k, v in batch.items()})
        loss = loss + l
        for a, gi in zip(acc, g):
            a.add_(gi)
    return loss / accum, nest(zip(paths, [a / accum for a in acc]))


def train_step(params, opt_state: dict, batch: dict, *, cfg: ModelConfig,
               opt: AdamWConfig, accum: int = 1, chunk: int = 1024):
    """One step: (params, new opt_state, loss). The params' leaves and the
    moments are updated in place, so the params returned are `params`."""
    loss, grads = loss_and_grads(params, cfg, batch, accum=accum, chunk=chunk)
    params, opt_state = apply_updates(opt, params, grads, opt_state)
    return params, opt_state, loss


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, accum: int = 1,
                    chunk: int = 1024):
    """`train_step` with its configuration bound. The reference jits it
    and donates params and state; here the update is in place, so there
    is nothing to donate."""
    return functools.partial(train_step, cfg=cfg, opt=opt, accum=accum,
                             chunk=chunk)
