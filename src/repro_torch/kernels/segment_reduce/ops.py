"""Launch wrapper of the gather + segmented reduce CUDA kernel (K3).

Source: `src/repro_torch/csrc/segment_reduce.cu` (what it replaces and what
bounds it is noted there). For CUDA tensors the wrapper checks and launches
the kernel on PyTorch's current stream and adds one to
`_build.LAUNCHES["segment_reduce"]`; for CPU tensors it runs the plain
version in `ref.py`; any other device raises.
"""
from __future__ import annotations

import torch

from .. import _build, csr_tiles
from . import ref

_SIGS = {
    "segment_reduce": (_build.P, _build.I64, _build.P, _build.P, _build.I64,
                       _build.P, _build.P, _build.I32, _build.P, _build.I32,
                       _build.I32, _build.F32, _build.I32, _build.I32,
                       _build.I32, _build.P),
}
OPS = ("sum", "min")
MAX_B = 65535                                   # grid.y walks the columns


def segment_reduce(edge_vals: torch.Tensor, delivered: torch.Tensor,
                   gather: torch.Tensor, indptr: torch.Tensor, op: str,
                   identity: float,
                   tiles: csr_tiles.Tiles | None = None) -> torch.Tensor:
    """Per-row `op` ("sum" | "min") over concat(edge_vals,
    floats(delivered))[gather], in the order of `ref.csr_reduce_seq` (CSR
    entry order; a long row in chunks).

    edge_vals [nnz(, B)] float32 Map output; delivered [M(, B)] int32 codec
    words from the decode; gather [indptr[n]] int32 into the concatenation
    (nnz entries, or fewer where only some rows of the graph are reduced);
    indptr [n + 1] int32 -> [n(, B)] float32 (identity for empty rows).
    `tiles` is the kernel's tile table (`csr_tiles.tiles_on(indptr, dev)`;
    built here when None), whose E the kernel cuts long rows at: a Reduce
    of some rows of a graph passes a table built with the graph's E; the
    CPU does not need it.
    """
    if op not in OPS:
        raise ValueError(f"unknown reduce op {op!r}; expected one of {OPS}")
    if not _build.on_cuda(edge_vals, delivered, gather, indptr):
        return ref.segment_reduce(edge_vals, delivered, gather, indptr, op,
                                  identity)
    nnz = edge_vals.shape[0]
    B = 1 if edge_vals.dim() == 1 else edge_vals.shape[1]
    n = indptr.shape[0] - 1
    if B > MAX_B:
        raise ValueError(f"B = {B} columns; the kernel takes <= {MAX_B}")
    _build.check_tensor(edge_vals, "edge_vals", torch.float32)
    _build.check_tensor(delivered, "delivered", torch.int32,
                        (delivered.shape[0],) + tuple(edge_vals.shape[1:]))
    _build.check_tensor(gather, "gather", torch.int32, (gather.shape[0],))
    _build.check_tensor(indptr, "indptr", torch.int32)
    if gather.data_ptr() % 16:
        raise ValueError("gather must start 16-byte aligned")
    tiles = csr_tiles.tiles_for(indptr, tiles)
    out = torch.empty((n,) + tuple(edge_vals.shape[1:]), dtype=torch.float32,
                      device=edge_vals.device)
    lib = _build.library("segment_reduce", _SIGS)
    with torch.cuda.device(edge_vals.device):
        code = lib.segment_reduce(
            edge_vals.data_ptr(), nnz, delivered.data_ptr(), gather.data_ptr(),
            gather.shape[0], indptr.data_ptr(), tiles.table.data_ptr(),
            tiles.table.numel() - 1, out.data_ptr(), B, int(op == "min"),
            float(identity), tiles.entries, csr_tiles.LONG_CHUNK,
            tiles.ring, _build.stream_of(edge_vals))
    _build.check(lib, "segment_reduce", code)
    _build.LAUNCHES["segment_reduce"] += 1
    return out
