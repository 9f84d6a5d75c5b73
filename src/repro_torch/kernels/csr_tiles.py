"""The tile table of the CSR-streaming kernels (K3 `segment_reduce`, K5
`spmv_csr`; `csrc/csr_stream.cuh`).

A block of either kernel takes one tile: whole consecutive rows holding at
most E CSR entries (and at most as many rows), or a single row longer
than that, a long tile, which the block walks in parts. E is
`tile_entries(nnz)`: 2048, or less where a small graph would leave the
card short of blocks. A long tile's row is summed in chunks of
`LONG_CHUNK` entries from its first (`segment_reduce/ref.csr_reduce_seq`
gives the order); the wrappers pass the table's E and `LONG_CHUNK` to the
kernels, so Python and CUDA agree on both. The
table is `tile_row` [T + 1] int32, tile t being rows tile_row[t] ..
tile_row[t + 1] - 1. It depends on `indptr` only, not on the payload
width B, so a session builds it once for every route
(`core/engine.CompiledEngine`), as a `Tiles` that carries the E it was
built with and counts the long rows at that E; the op-level wrappers
build it from `indptr` when the caller passes none. A Reduce of some rows
of a graph (a rank's own rows on a process group) builds its table with
the graph's E, so its rows are cut, and summed, as the graph's are.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

TILE_ENTRIES = 2048       # E: entries a block stages in shared memory at once
MIN_TILE_ENTRIES = 256
TARGET_TILES = 512        # about 4 blocks for each of the H100's 132 SMs
LONG_CHUNK = 32           # S: entries of a long row reduced in order as one chunk


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


def long_rows(indptr, entries: int | None = None) -> tuple[int, int]:
    """(rows, entries) on the kernels' long-tile path: the rows of more than
    `entries` (by default `tile_entries(nnz)`) entries, and the entries
    they hold."""
    ip = np.asarray(indptr, dtype=np.int64)
    deg = np.diff(ip)
    long = deg > (tile_entries(int(ip[-1])) if entries is None else entries)
    return int(long.sum()), int(deg[long].sum())


class Tiles(NamedTuple):
    """The tile table on a device, with the E it was built with and the
    long-tile rows counted at that E beside it: all that a launch reads of
    `indptr`, so a call copies nothing back to the host."""
    table: torch.Tensor     # tile_row [T + 1] int32
    long_rows: int          # rows of more than `entries` entries
    long_entries: int       # the entries they hold
    entries: int            # E: the kernels' tile size and long-row bound

    @property
    def ring(self) -> int:
        """1 where the launch gives every block the long tiles' ring of
        shared memory, else 0. Correct either way: the ring speeds up long
        rows, and without it a launch keeps the multi-row path's L1."""
        return int(self.long_rows > 0)


def tiles_on(indptr, device, entries: int | None = None) -> Tiles:
    """`Tiles` for a host CSR row pointer [n + 1], the table on `device`:
    E is `entries`, by default `tile_entries(nnz)`."""
    ip = np.asarray(indptr)
    if entries is None:
        entries = tile_entries(int(ip[-1]))
    return Tiles(torch.from_numpy(tile_rows(ip, entries)).to(device),
                 *long_rows(ip, entries), entries)


def tiles_for(indptr: torch.Tensor, tiles: Tiles | None) -> Tiles:
    """`tiles` as given (checked), or built from `indptr` on its device (a
    copy to the host and back)."""
    if tiles is None:
        return tiles_on(indptr.cpu().numpy(), indptr.device)
    if not isinstance(tiles, Tiles):
        raise ValueError(f"tiles must be csr_tiles.Tiles, got {type(tiles)}")
    t = tiles.table
    if (t.dtype != torch.int32 or t.dim() != 1 or t.numel() < 1
            or not t.is_contiguous()):
        raise ValueError(f"tiles.table must be contiguous int32 [T + 1], got "
                         f"{t.dtype} {tuple(t.shape)}")
    return tiles
