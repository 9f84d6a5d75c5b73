"""Gradient compression for the data-parallel all-reduce: int8 with a
per-tensor scale, and error feedback. The port of the reference's
`train/compression.py`.

The reference's mesh axis is a `torch.distributed` process group here
(as in `launch/dist.py`): `compressed_psum_mean(x, group)` takes the MAX
of the ranks' scales, requantizes x against it, sums the int32 payloads
with one SUM all-reduce and divides by the world size. The reference also
psums its first, per-rank quantization (`compression.py:41`) and then
overwrites the result; that dead collective is not sent here. `wire_bytes`
keeps the reference's accounting of 1 byte per element. `ef_compress_tree`
walks the leaves in sorted-key order, so every rank issues the same
collectives in the same order.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.layers import map_tree, named_leaves, nest

F32 = torch.float32


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 payload, float32 scale): symmetric per-tensor,
    scale = max(max|x|, 1e-12) / 127, q = clip(round(x / scale), -127, 127)
    (round half to even). The division by 127 is a product with float32
    1/127, as XLA compiles the reference's (and as CUDA divides by a
    scalar), so the scale is the reference's bit for bit."""
    x = x.to(F32)
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compressed_psum_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of x over the ranks of `group` (default the world), int8 on
    the wire: each rank requantizes against the largest scale of all
    ranks, the int32 sum of the payloads is exact, and the mean is
    qsum * scale_max / n."""
    _, scale = quantize(x)
    scale_max = scale.reshape(1).clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    scale_max = scale_max.reshape(())
    n = torch.tensor(float(dist.get_world_size(group)), dtype=F32,
                     device=x.device)
    q2 = torch.clamp(torch.round(x.to(F32) / scale_max), -127, 127)
    qsum = q2.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    return qsum.to(F32) * scale_max / n


def ef_state(params) -> dict:
    """The error-feedback residual: float32 zeros under the params' keys."""
    return map_tree(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
                    params)


def _residual(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x - dequantize(q, scale), rounded once: the product q * scale is
    exact in float64 and so is the difference of such close numbers, so
    this is the fused multiply-add that XLA compiles the reference's
    `corrected - dequantize(q, scale)` into."""
    return (x.to(torch.float64) - q.to(torch.float64) * scale.to(torch.float64)).to(F32)


def ef_compress_tree(grads, residual, group=None) -> tuple[dict, dict]:
    """Error feedback plus the compressed mean over `group` for every leaf:
    (reduced grads, new residual), the residual carrying what this rank's
    own quantization of g + r lost into the next step."""
    res = dict(named_leaves(residual))
    reduced, new_res = [], []
    for path, g in named_leaves(grads):
        corrected = g.to(F32) + res[path]
        q, scale = quantize(corrected)
        reduced.append((path, compressed_psum_mean(corrected, group)))
        new_res.append((path, _residual(corrected, q, scale)))
    return nest(reduced), nest(new_res)


def wire_bytes(params, compressed: bool) -> int:
    """Gradient bytes on the interconnect per device per step (accounting:
    1 byte per element compressed, 4 uncompressed)."""
    total = sum(p.numel() for _, p in named_leaves(params))
    return total * (1 if compressed else 4)
