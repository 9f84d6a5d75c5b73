"""Shared layers of the port's model path: declarative params, RMSNorm.

The part of the reference's `models/layers.py` that the Mamba2 serving path
needs. Params are declared as `ParamSpec` trees (one source of truth for
shape, logical axes and init) and held in a `Params` module under the
reference's keys, so ``p["layers"]["mixer"]["in_proj"]`` names the same
tensor in both packages. Attention, RoPE, GeGLU and the cross-entropy wait
for the dense families (ROADMAP Queue 1 #12).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Mapping

import torch
from torch import nn

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]     # logical axis names, len == len(shape)
    init: str = "normal"             # normal | zeros | ones | ssm_dt | ssm_a

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


class Params(nn.Module):
    """A parameter tree under the reference's keys.

    Leaves are frozen `nn.Parameter`s (the port serves; nothing trains
    yet), inner nodes are child `Params`; ``p[key]`` reads either, and
    `state_dict()` names each leaf by its dotted path.
    """

    def __init__(self, tree: Mapping[str, object]):
        super().__init__()
        for key in sorted(tree):
            v = tree[key]
            if isinstance(v, Mapping):
                self.add_module(key, Params(v))
            else:
                self.register_parameter(
                    key, nn.Parameter(torch.as_tensor(v), requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def keys(self) -> Iterator[str]:
        yield from sorted([*self._parameters, *self._modules])


def _leaves(spec, prefix=()) -> Iterator[tuple[tuple[str, ...], ParamSpec]]:
    """(path, ParamSpec) in the reference's flatten order (sorted keys)."""
    for key in sorted(spec):
        v = spec[key]
        if isinstance(v, ParamSpec):
            yield prefix + (key,), v
        else:
            yield from _leaves(v, prefix + (key,))


def _nest(items) -> dict:
    tree: dict = {}
    for path, v in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def init_params(spec, generator: torch.Generator, dtype=torch.bfloat16,
                device: str | torch.device | None = "cuda") -> Params:
    """Random params for `spec`, drawn from `generator` in the reference's
    distributions (`layers.py:28-48`): normal / sqrt(fan_in) with fan_in the
    leading dim of a 2-D+ shape (the layer count, for stacked params, as in
    the reference), `ssm_dt` = log(expm1(U(0.001, 0.1))), `ssm_a` =
    log(U(1, 16)), zeros, ones; drawn in float32, then cast to `dtype`.

    `generator` must live on `device` (default the card, which raises
    without one). The bits are not JAX's for the same seed.
    """
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, params go to "
                         f"{dev}; make the generator on the same device")
    f32 = dict(dtype=torch.float32, device=dev, generator=generator)
    out = []
    for path, p in _leaves(spec):
        if p.init == "zeros":
            v = torch.zeros(p.shape, dtype=dtype, device=dev)
        elif p.init == "ones":
            v = torch.ones(p.shape, dtype=dtype, device=dev)
        elif p.init == "ssm_dt":
            u = torch.rand(p.shape, **f32) * (0.1 - 0.001) + 0.001
            v = torch.log(torch.expm1(u)).to(dtype)
        elif p.init == "ssm_a":
            u = torch.rand(p.shape, **f32) * (16.0 - 1.0) + 1.0
            v = torch.log(u).to(dtype)
        else:
            fan_in = p.shape[0] if len(p.shape) > 1 else p.shape[-1]
            v = (torch.randn(p.shape, **f32) / math.sqrt(fan_in)).to(dtype)
        out.append((path, v))
    return Params(_nest(out))


# ---------------- primitives ----------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in the (1 + scale) form, float32 inside, out in x's dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)
