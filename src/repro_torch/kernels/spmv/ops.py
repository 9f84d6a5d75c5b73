"""Public spmv ops under the reference package's names.

Same contracts as `repro.kernels.spmv.ops` where they mean something on the
card. On CUDA tensors they launch the hand-written kernels of `spmv.py`
(K4 for the dense product, K5 for the CSR row sums); on CPU tensors those
wrappers run the plain versions in `ref.py`. The reference pads to its
[bm, bk] tile grid and densifies CSR row strips on the host; K4 masks the
ragged edge itself and K5 reads the CSR arrays directly, so neither pads
nor densifies. `interpret` and `use_kernel` are TPU and reference switches
that the port does not take (passing them raises `TypeError`).
"""
from __future__ import annotations

import numpy as np
import torch

from .spmv import DENSE_DTYPES, check_bm, spmv_csr, spmv_dense


def _tensor(a, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dtype)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _check_tile(name: str, v) -> None:
    if isinstance(v, bool) or not isinstance(v, (int, np.integer)) or v < 1:
        raise ValueError(f"{name} must be a positive int, got {v!r}")


def spmv(adj: torch.Tensor, x: torch.Tensor, *, bm: int = 128,
         bk: int = 128) -> torch.Tensor:
    """y = adj @ x, float32 accumulation, [m] float32 out.

    `bm` and `bk` are the reference's tile shape: validated (positive ints)
    and without effect on K4's result. An adjacency or vector in another
    dtype is cast to float32 first, as the reference does.
    """
    _check_tile("bm", bm)
    _check_tile("bk", bk)
    if adj.dtype not in DENSE_DTYPES:
        adj = adj.to(torch.float32)
    if x.dtype not in DENSE_DTYPES:
        x = x.to(torch.float32)
    return spmv_dense(adj.contiguous(), x.contiguous())


def pagerank_step(adj: torch.Tensor, rank: torch.Tensor,
                  damping: float = 0.15, **kw) -> torch.Tensor:
    """One PageRank iteration on a dense adjacency: K4 for the product,
    tensor code for the degrees (`max(adj.sum(0), 1)`, summed in float32)
    and the finalize. `kw` goes to `spmv` (bm, bk)."""
    deg = torch.clamp(adj.sum(0, dtype=torch.float32), min=1.0)
    acc = spmv(adj, rank.to(torch.float32) / deg, **kw)
    return (1.0 - damping) * acc + damping / adj.shape[0]


def spmv_csr_rows(indptr, indices, c, n: int, *, rows=None,
                  bm: int = 128, tiles=None) -> torch.Tensor:
    """acc[i] = sum_{j in row i} c[j] from a CSR adjacency, via K5.

    indptr [n + 1], indices [nnz], c [n] or [n, B]: tensors (cast on their
    own device, never moved) or NumPy arrays (taken as CPU tensors) ->
    [n] or [n, B] float32. `bm` is the reference's rows per tile (a power
    of two, 1..256, validated; K5's result does not depend on it); `rows`,
    the reference's cached per-entry row array, is accepted and not
    needed. `tiles` is K5's tile table (`csr_tiles.tiles_on(indptr, dev)`),
    built from `indptr` when None.
    """
    del rows
    bm = check_bm(bm)
    c, indptr, indices = (_tensor(a, dt) for a, dt in (
        (c, torch.float32), (indptr, torch.int32), (indices, torch.int32)))
    if indptr.numel() != n + 1 or c.shape[0] != n:
        raise ValueError(
            f"n={n} needs indptr [n + 1] and c [n(, B)]; got indptr "
            f"{tuple(indptr.shape)}, c {tuple(c.shape)}")
    return spmv_csr(indptr.contiguous(), indices.contiguous(),
                    c.contiguous(), bm=bm, tiles=tiles)
