"""Plain PyTorch versions of the spmv kernels (any device).

Written from the reference's `kernels/spmv/ref.py`. The CPU runs these (the
wrappers in `spmv.py` pick them only for CPU tensors), and `chip_smoke.py`
holds the CUDA kernels against them on the card. `spmv` is a float32
matrix product: set `torch.backends.cuda.matmul.allow_tf32 = False` where it
serves as the float32 reference on a card. On the card `index_add_` sums
with atomics, in no fixed order.
"""
from __future__ import annotations

import torch

from ..segment_reduce.ref import csr_reduce_seq


def spmv(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = adj @ x with float32 accumulation.

    adj [m, n] float32 or float16 (a dense {0, 1} or weighted adjacency),
    x [n] -> [m] float32.
    """
    return torch.mv(adj.to(torch.float32), x.to(torch.float32))


def spmv_csr(indptr: torch.Tensor, indices: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """acc[i] = sum of c[j] over the CSR row i (0 for empty rows).

    indptr [n + 1] int, indices [nnz] int, c [n] or [n, B] float32 ->
    [n] or [n, B] float32.
    """
    indptr = indptr.long()
    n = indptr.numel() - 1
    rows = torch.repeat_interleave(torch.arange(n, device=c.device),
                                   indptr[1:] - indptr[:-1])
    out = torch.zeros((n,) + tuple(c.shape[1:]), dtype=torch.float32,
                      device=c.device)
    return out.index_add_(0, rows, c[indices.long()])


def spmv_csr_seq(indptr: torch.Tensor, indices: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """K5's sequential plain version: `spmv_csr` with every row summed in
    the order K5 sums in (`segment_reduce.ref.csr_reduce_seq`: CSR order
    from the first value, a row longer than `csr_tiles.tile_entries(nnz)`
    in chunks of `csr_tiles.LONG_CHUNK`), so K5 is held bitwise against
    it."""
    return csr_reduce_seq(c[indices.long()], indptr, "sum", 0.0)


def pagerank_step(adj: torch.Tensor, rank: torch.Tensor,
                  damping: float = 0.15) -> torch.Tensor:
    """One full PageRank iteration (paper Example 1) on a dense adjacency."""
    deg = torch.clamp(adj.sum(0, dtype=torch.float32), min=1.0)
    acc = spmv(adj, rank / deg)
    return (1.0 - damping) * acc + damping / adj.shape[0]
