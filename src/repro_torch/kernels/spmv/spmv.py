"""Launch wrappers of the dense (K4) and CSR (K5) spmv CUDA kernels.

Source: `src/repro_torch/csrc/spmv.cu` (what each kernel replaces and what
bounds it is noted there). Each wrapper checks dtype, contiguity and shape
on any device, then either launches its kernel on PyTorch's current stream
for CUDA tensors (allocating the output with `torch.empty`, raising on a
launch error, adding one to `_build.LAUNCHES[<kernel>]`) or runs the plain
version in `ref.py` for CPU tensors; any other device, or a mix, raises.
"""
from __future__ import annotations

import torch

from .. import _build, csr_tiles
from . import ref

_SIGS = {
    "spmv_dense": (_build.P, _build.I32, _build.P, _build.I32, _build.P,
                   _build.I64, _build.I64, _build.P),
    "spmv_csr": (_build.P, _build.P, _build.I32, _build.P, _build.P,
                 _build.P, _build.I32, _build.I32, _build.I32, _build.I32,
                 _build.I32, _build.P),
}
DENSE_DTYPES = (torch.float32, torch.float16)
ROW_TILES = tuple(2 ** k for k in range(9))     # bm: 1, 2, 4, ..., 256
MAX_B = 65535                                   # grid.y walks the columns


def _lib():
    return _build.library("spmv", _SIGS)


def check_bm(bm) -> int:
    """`bm`, the reference's rows per tile, must be a power of two, 1..256
    (validated as the reference's argument; K5's result does not depend
    on it)."""
    if isinstance(bm, bool) or bm not in ROW_TILES:
        raise ValueError(
            f"bm must be a power of two from 1 to 256, got {bm!r}")
    return int(bm)


def spmv_dense(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K4: y = adj @ x; adj [m, n] and x [n] float32 or float16, y [m]
    float32 (float32 products and sums)."""
    for t, name in ((adj, "adj"), (x, "x")):
        if t.dtype not in DENSE_DTYPES:
            raise TypeError(f"{name} must be float32 or float16, got {t.dtype}")
    if adj.dim() != 2:
        raise ValueError(f"adj must be [m, n], got shape {tuple(adj.shape)}")
    m, n = adj.shape
    _build.check_tensor(adj, "adj", adj.dtype)
    _build.check_tensor(x, "x", x.dtype, (n,))
    if not _build.on_cuda(adj, x):
        return ref.spmv(adj, x)
    y = torch.empty(m, dtype=torch.float32, device=adj.device)
    lib = _lib()
    with torch.cuda.device(adj.device):
        code = lib.spmv_dense(adj.data_ptr(), int(adj.dtype == torch.float16),
                              x.data_ptr(), int(x.dtype == torch.float16),
                              y.data_ptr(), m, n, _build.stream_of(adj))
    _build.check(lib, "spmv_dense", code)
    _build.LAUNCHES["spmv_dense"] += 1
    return y


def spmv_csr(indptr: torch.Tensor, indices: torch.Tensor, c: torch.Tensor,
             bm: int = 128,
             tiles: csr_tiles.Tiles | None = None) -> torch.Tensor:
    """K5: acc[i(, b)] = sum of c[indices[e](, b)] over e in row i, in the
    order of `ref.spmv_csr_seq` (CSR order; a long row in chunks).

    indptr [n + 1] int32, indices [nnz] int32, c [n] or [n, B] float32 ->
    [n] or [n, B] float32 (0 for empty rows). `bm` is validated only;
    `tiles` is the kernel's tile table (`csr_tiles.tiles_on(indptr, dev)`,
    built here when None).
    """
    check_bm(bm)
    if c.dim() not in (1, 2):
        raise ValueError(f"c must be [n] or [n, B], got shape {tuple(c.shape)}")
    n = c.shape[0]
    B = 1 if c.dim() == 1 else c.shape[1]
    if B > MAX_B:
        raise ValueError(f"c has B={B} columns; the kernel takes <= {MAX_B}")
    _build.check_tensor(indptr, "indptr", torch.int32, (n + 1,))
    _build.check_tensor(indices, "indices", torch.int32)
    _build.check_tensor(c, "c", torch.float32)
    if indices.dim() != 1:
        raise ValueError(f"indices must be [nnz], got {tuple(indices.shape)}")
    if not _build.on_cuda(indptr, indices, c):
        return ref.spmv_csr(indptr, indices, c)
    if indices.data_ptr() % 16:
        raise ValueError("indices must start 16-byte aligned")
    tiles = csr_tiles.tiles_for(indptr, tiles)
    out = torch.empty(c.shape, dtype=torch.float32, device=c.device)
    lib = _lib()
    with torch.cuda.device(c.device):
        code = lib.spmv_csr(indptr.data_ptr(), indices.data_ptr(),
                            indices.numel(), c.data_ptr(), out.data_ptr(),
                            tiles.table.data_ptr(), tiles.table.numel() - 1, B,
                            tiles.entries, csr_tiles.LONG_CHUNK, tiles.ring,
                            _build.stream_of(c))
    _build.check(lib, "spmv_csr", code)
    _build.LAUNCHES["spmv_csr"] += 1
    return out
