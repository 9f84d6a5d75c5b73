"""AdamW with float32 moments, global-norm clipping and a cosine schedule.
The port of the reference's `train/optimizer.py`.

The optimizer state is ``{"m": tree, "v": tree, "step": int32 scalar}``,
the moment trees nested dicts of float32 tensors under the params' keys
(`core/convert.opt_state` carries the reference's across). `apply_updates`
runs the reference's arithmetic, every product and sum in float32 in the
same order, and writes the new params and moments in place, into the same
leaves. It is not `torch.optim.AdamW`, whose moments take the params'
dtype (bf16 here), which decays as p * (1 - lr * wd) before the step and
has no global-norm clip or schedule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..models.layers import map_tree, named_leaves

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate (float32) at `step` (an int32 scalar): a linear
    warm-up over `warmup_steps`, then a cosine from lr down to 0.1 lr at
    `total_steps`."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_state(params) -> dict:
    """Zero moments (float32, on each leaf's device) and step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    leaf = next(t for _, t in named_leaves(params))
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf, summed leaf after
    leaf in the tree's sorted-key order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for _, x in named_leaves(tree)))


def apply_updates(cfg: AdamWConfig, params, grads, state: dict
                  ) -> tuple[Any, dict]:
    """One AdamW step. Gradients are scaled by min(1, clip / (norm +
    1e-9)); the moments are bias-corrected by 1 - b ** (step + 1); each
    param becomes p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p) in
    float32, cast back to its dtype. Params and moments are written in
    place; returns (params, {"m", "v", "step": step + 1})."""
    step = state["step"]
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(torch.div(gnorm.new_tensor(cfg.clip_norm), gnorm + 1e-9),
                        max=1.0)
    bc1 = 1 - cfg.b1 ** (step + 1)
    bc2 = 1 - cfg.b2 ** (step + 1)
    g_of = dict(named_leaves(grads))
    m_of, v_of = dict(named_leaves(state["m"])), dict(named_leaves(state["v"]))
    with torch.no_grad():
        for path, p in named_leaves(params):
            m, v = m_of[path], v_of[path]
            g = g_of[path].to(F32) * scale
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            p32 = p.to(F32)
            p.copy_(p32 - lr * (m / bc1 / (torch.sqrt(v / bc2) + cfg.eps)
                                + cfg.weight_decay * p32))
    return params, {"m": state["m"], "v": state["v"], "step": step + 1}
