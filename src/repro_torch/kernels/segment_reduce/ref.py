"""Plain PyTorch version of the gather + segmented reduce kernel (K3).

The CPU runs it (the wrapper in `ops.py` picks it only for CPU tensors),
and `chip_smoke.py` holds the CUDA kernel against it on the card. On the
card `index_add_` sums with atomics, in no fixed order; `scatter_reduce_`
with "amin" is exact in any order.
"""
from __future__ import annotations

import torch

from ...core.bitcodec import words_to_floats_t


def segment_reduce(edge_vals: torch.Tensor, delivered: torch.Tensor,
                   gather: torch.Tensor, indptr: torch.Tensor, op: str,
                   identity: float) -> torch.Tensor:
    """Per-row `op` over concat(edge_vals, floats(delivered))[gather].

    edge_vals [nnz(, B)] float32; delivered [M(, B)] int32 codec words;
    gather [nnz] int; indptr [n + 1] int -> [n(, B)] float32, identity for
    empty rows.
    """
    vals = torch.cat([edge_vals, words_to_floats_t(delivered)])[gather.long()]
    indptr = indptr.long()
    n = indptr.numel() - 1
    rows = torch.repeat_interleave(torch.arange(n, device=vals.device),
                                   indptr[1:] - indptr[:-1])
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=torch.float32,
                      device=vals.device)
    if op == "sum":
        out.index_add_(0, rows, vals)
    elif op == "min":
        idx = rows.reshape((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
        out.scatter_reduce_(0, idx, vals, "amin", include_self=False)
    else:
        raise ValueError(f"unknown reduce op {op!r}")
    out[indptr[1:] == indptr[:-1]] = identity
    return out
