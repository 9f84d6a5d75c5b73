"""The tile table of the CSR-streaming kernels (K3 `segment_reduce`, K5
`spmv_csr`; `csrc/csr_stream.cuh`).

A block of either kernel takes one tile: whole consecutive rows holding at
most E CSR entries (and at most as many rows), or a single row longer
than that, a long tile, which the block walks in parts. E is
`tile_entries(nnz)`: 2048, or less where a small graph would leave the
card short of blocks. The
table is `tile_row` [T + 1] int32, tile t being rows tile_row[t] ..
tile_row[t + 1] - 1. It depends on `indptr` only, not on the payload
width B, so a session builds it once for every route
(`core/engine.CompiledEngine`); the op-level wrappers build it from
`indptr` when the caller passes none.
"""
from __future__ import annotations

import numpy as np
import torch

TILE_ENTRIES = 2048       # E: entries a block stages in shared memory at once
MIN_TILE_ENTRIES = 256
TARGET_TILES = 512        # about 4 blocks for each of the H100's 132 SMs


def tile_entries(nnz: int) -> int:
    """E for a CSR of `nnz` entries: TILE_ENTRIES, halved (down to
    MIN_TILE_ENTRIES) while the tiles would number fewer than TARGET_TILES,
    so a small graph still fills the card. The kernels' wrappers and
    `tile_rows` both derive it from nnz, so they agree."""
    e = TILE_ENTRIES
    while e > MIN_TILE_ENTRIES and nnz < e * TARGET_TILES:
        e //= 2
    return e


def tile_rows(indptr, entries: int | None = None) -> np.ndarray:
    """tile_row [T + 1] int32 from a CSR row pointer [n + 1].

    Greedy, row order: each tile ends at the last row whose end stays
    within `entries` entries (and `entries` rows) of the tile's start, by
    a searchsorted on `indptr`; a row of more than `entries` entries is a
    tile of its own. `entries` defaults to `tile_entries(nnz)`; a table
    built with a smaller E serves the kernels too. Tiles cover every row
    exactly once; n = 0 gives [0].
    """
    ip = np.asarray(indptr, dtype=np.int64)
    if entries is None:
        entries = tile_entries(int(ip[-1]))
    if entries < 4 or entries % 4:
        raise ValueError(f"entries must be a positive multiple of 4, got {entries}")
    n = ip.size - 1
    bounds = [0]
    row = 0
    while row < n:
        end = int(np.searchsorted(ip, ip[row] + entries, side="right")) - 1
        end = min(end, row + entries, n)
        row = end if end > row else row + 1
        bounds.append(row)
    return np.asarray(bounds, dtype=np.int32)


def tiles_for(indptr: torch.Tensor, tiles: torch.Tensor | None) -> torch.Tensor:
    """The tile table on indptr's device: `tiles` as given (checked), or
    built from `indptr` (a copy to the host and back)."""
    if tiles is None:
        tiles = torch.from_numpy(tile_rows(indptr.cpu().numpy())).to(
            indptr.device)
    if tiles.dtype != torch.int32 or tiles.dim() != 1 or tiles.numel() < 1:
        raise ValueError(f"tiles must be int32 [T + 1], got {tiles.dtype} "
                         f"{tuple(tiles.shape)}")
    return tiles.contiguous()
