"""Plain PyTorch versions of the gather + segmented reduce kernel (K3).

`segment_reduce` is what the CPU runs (the wrapper in `ops.py` picks it
only for CPU tensors). On the card `index_add_` sums with atomics, in no
fixed order; `scatter_reduce_` with "amin" is exact in any order.

`csr_reduce_seq` is the sequential plain version of the CSR-streaming
body that K3 and K5 share (`csrc/csr_stream.cuh`), in the kernels' fixed
order: a row of at most E = `csr_tiles.tile_entries(nnz)` entries reduced
in CSR order from its first value, every add rounded on its own; a longer
row (a long tile) cut into chunks of S = `csr_tiles.LONG_CHUNK` entries
from its first, each chunk reduced so, and the chunk results combined so,
left to right from chunk 0's. The kernels' sums are held bitwise against
it on the card (`segment_reduce_seq` for K3, `spmv/ref.spmv_csr_seq` for
K5). `min` gives the same bits in either order.
"""
from __future__ import annotations

import torch

from ...core.bitcodec import words_to_floats_t
from .. import csr_tiles


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


def _in_order(vals: torch.Tensor, start: torch.Tensor, deg: torch.Tensor,
              op: str, identity: float) -> torch.Tensor:
    """Per-run `op` over vals[start[i] : start[i] + deg[i]] in order.

    Run i starts from vals[start[i]] and combines position k = 1, 2, ...
    in turn, vectorised over the runs that have a position k: a float32
    add per step for "sum", NumPy's minimum rule (keep the accumulator when
    it is <= the value or NaN) for "min". Empty runs get `identity`.
    """
    out = torch.full((deg.numel(),) + tuple(vals.shape[1:]), identity,
                     dtype=torch.float32, device=vals.device)
    if deg.numel() == 0 or vals.shape[0] == 0:
        return out
    order = torch.argsort(deg, descending=True, stable=True)
    # counts[k]: the runs with a position k, a prefix of `order`; read to
    # the host once, so the steps below never wait on the device.
    counts = (deg.numel() - torch.cumsum(torch.bincount(deg), 0)).tolist()
    runs = order[:counts[0]]
    pos = start[runs]
    acc = vals[pos].to(torch.float32)          # [runs, B] in `order`
    for k in range(1, len(counts) - 1):
        a, v = acc[:counts[k]], vals[pos[:counts[k]] + k]
        if op == "sum":
            a += v
        else:
            a.copy_(torch.where((a <= v) | torch.isnan(a), a, v))
    out[runs] = acc
    return out


def csr_reduce_seq(vals: torch.Tensor, indptr: torch.Tensor, op: str,
                   identity: float) -> torch.Tensor:
    """Per-row `op` over vals [nnz(, B)] float32, in the kernels' order.

    A row of at most E = `csr_tiles.tile_entries(nnz)` entries is one run
    in CSR order (`_in_order`). A longer row is cut into runs of S =
    `csr_tiles.LONG_CHUNK` entries from its first (the last may be short),
    and its run results are combined as one run in turn: chunk 0's, then
    chunk 1's, and so on. Empty rows get `identity`. -> [n(, B)] float32.
    """
    if op not in ("sum", "min"):
        raise ValueError(f"unknown reduce op {op!r}")
    indptr = indptr.long()
    start, deg = indptr[:-1], indptr[1:] - indptr[:-1]
    long = deg > csr_tiles.tile_entries(vals.shape[0])
    if not bool(long.any()):
        return _in_order(vals, start, deg, op, identity)
    S = csr_tiles.LONG_CHUNK
    # A run per short row, ceil(deg / S) per long row, in row order.
    runs = torch.where(long, (deg + S - 1) // S, torch.ones_like(deg))
    first = torch.cumsum(runs, 0) - runs
    row = torch.repeat_interleave(
        torch.arange(deg.numel(), device=deg.device), runs)
    off = (torch.arange(row.numel(), device=deg.device) - first[row]) * S
    run_deg = torch.where(long[row], torch.clamp(deg[row] - off, max=S),
                          deg[row])
    chunks = _in_order(vals, start[row] + off, run_deg, op, identity)
    return _in_order(chunks, first, runs, op, identity)


def segment_reduce_seq(edge_vals: torch.Tensor, delivered: torch.Tensor,
                       gather: torch.Tensor, indptr: torch.Tensor, op: str,
                       identity: float) -> torch.Tensor:
    """K3's sequential plain version: `csr_reduce_seq` over
    concat(edge_vals, floats(delivered))[gather]."""
    vals = torch.cat([edge_vals, words_to_floats_t(delivered)])[gather.long()]
    return csr_reduce_seq(vals, indptr, op, identity)
