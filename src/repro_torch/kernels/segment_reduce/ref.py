"""Plain PyTorch versions of the gather + segmented reduce kernel (K3).

`segment_reduce` is what the CPU runs (the wrapper in `ops.py` picks it
only for CPU tensors). On the card `index_add_` sums with atomics, in no
fixed order; `scatter_reduce_` with "amin" is exact in any order.

`csr_reduce_seq` is the sequential plain version of the CSR-streaming
body that K3 and K5 share (`csrc/csr_stream.cuh`): each row reduced in
CSR order from its first value, every add rounded on its own, so the
kernels' sums are held bitwise against it on the card
(`segment_reduce_seq` for K3, `spmv/ref.spmv_csr_seq` for K5).
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


def csr_reduce_seq(vals: torch.Tensor, indptr: torch.Tensor, op: str,
                   identity: float) -> torch.Tensor:
    """Per-row `op` over vals [nnz(, B)] float32 in CSR order.

    Row i starts from vals[indptr[i]] and combines position k = 1, 2, ...
    of the row in turn, vectorised over the rows that have a position k:
    a float32 add per step for "sum", NumPy's minimum rule (keep the
    accumulator when it is <= the value or NaN) for "min". Empty rows get
    `identity`. -> [n(, B)] float32.
    """
    if op not in ("sum", "min"):
        raise ValueError(f"unknown reduce op {op!r}")
    indptr = indptr.long()
    n = indptr.numel() - 1
    start, deg = indptr[:-1], indptr[1:] - indptr[:-1]
    out = torch.full((n,) + tuple(vals.shape[1:]), identity,
                     dtype=torch.float32, device=vals.device)
    if n == 0 or vals.shape[0] == 0:
        return out
    order = torch.argsort(deg, descending=True, stable=True)
    # counts[k]: the rows with a position k, a prefix of `order`; read to
    # the host once, so the steps below never wait on the device.
    counts = (deg.numel() - torch.cumsum(torch.bincount(deg), 0)).tolist()
    rows = order[:counts[0]]
    pos = start[rows]
    acc = vals[pos].to(torch.float32)          # [rows, B] in `order`
    for k in range(1, len(counts) - 1):
        a, v = acc[:counts[k]], vals[pos[:counts[k]] + k]
        if op == "sum":
            a += v
        else:
            a.copy_(torch.where((a <= v) | torch.isnan(a), a, v))
    out[rows] = acc
    return out


def segment_reduce_seq(edge_vals: torch.Tensor, delivered: torch.Tensor,
                       gather: torch.Tensor, indptr: torch.Tensor, op: str,
                       identity: float) -> torch.Tensor:
    """K3's sequential plain version: `csr_reduce_seq` over
    concat(edge_vals, floats(delivered))[gather]."""
    vals = torch.cat([edge_vals, words_to_floats_t(delivered)])[gather.long()]
    return csr_reduce_seq(vals, indptr, op, identity)
