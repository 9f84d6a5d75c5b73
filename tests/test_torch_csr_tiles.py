"""The tile table of the CSR-streaming kernels (K3 / K5), on the CPU.

`csr_tiles.tile_rows(indptr)` cuts the rows into tiles of whole rows: every
row in exactly one tile, in order; no tile of several rows holds more than
E entries or E rows; a row of more than E entries is a tile of its own (a
long tile); empty rows, n = 1 and n = 0 are covered. The engine builds the
table once per session, for either route, and the wrappers build it from
`indptr` when none is passed. A session also sets the gauges
`reduce_long_rows` / `reduce_long_entries` (`csr_tiles.long_rows`): the
rows of more than `tile_entries(nnz)` entries and the entries they hold,
which the `csr_tiles.Tiles` it builds carries to every launch (whether
there are any sizes the kernels' shared memory: `Tiles.ring`).
"""
import numpy as np
import pytest
import torch

from repro_torch import graphs, obs
from repro_torch.core import algorithms as algo
from repro_torch.core import engine
from repro_torch.core.allocation import divisible_n, er_allocation
from repro_torch.kernels import csr_tiles


def _check_tiles(indptr, E):
    tiles = csr_tiles.tile_rows(indptr, E)
    ip = np.asarray(indptr, np.int64)
    n = ip.size - 1
    assert tiles.dtype == np.int32 and tiles[0] == 0 and tiles[-1] == n
    assert np.all(np.diff(tiles) > 0)                # every row once, in order
    rows = np.diff(tiles)
    entries = ip[tiles[1:]] - ip[tiles[:-1]]
    multi = rows > 1
    assert np.all(entries[multi] <= E) and np.all(rows <= E)
    long_rows = np.flatnonzero(np.diff(ip) > E)
    # A row past E entries is alone in its tile.
    assert np.array_equal(np.sort(tiles[:-1][entries > E]), long_rows)
    assert np.all(rows[entries > E] == 1)
    # Greedy: a tile of several rows could not take the next row too.
    nxt = tiles[1:-1]
    grown = ip[nxt + 1] - ip[tiles[:-2]]
    assert np.all((grown > E) | (rows[:-1] == E) | (entries[1:] > E))
    return tiles


@pytest.mark.parametrize("E", [4, 16, 2048])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiles_cover_every_row_once(seed, E):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3000))
    deg = rng.integers(0, 20, size=n)
    deg[rng.random(n) < 0.3] = 0                    # empty rows
    deg[rng.integers(0, n, size=3)] = 3 * E + 5      # long rows
    _check_tiles(np.concatenate([[0], np.cumsum(deg)]), E)


@pytest.mark.parametrize("deg", [[0], [5], [9000], [0, 0, 0], [4, 4, 4, 4],
                                 [3000, 0, 3000], [2048, 2048, 1, 2049]])
def test_tiles_edge_cases(deg):
    tiles = _check_tiles(np.concatenate([[0], np.cumsum(deg)]), 2048)
    assert tiles.size - 1 <= len(deg)


def test_tiles_of_no_rows_and_of_empty_rows():
    assert csr_tiles.tile_rows(np.zeros(1, np.int32)).tolist() == [0]
    # 5,000 empty rows: tiles of at most E rows.
    tiles = _check_tiles(np.zeros(5001, np.int64), 2048)
    assert tiles.tolist() == [0, 2048, 4096, 5000]


def test_tiles_reject_bad_sizes_and_tables():
    with pytest.raises(ValueError, match="multiple of 4"):
        csr_tiles.tile_rows(np.zeros(3), 6)
    ip = torch.tensor([0, 2, 5], dtype=torch.int32)
    built = csr_tiles.tiles_for(ip, None)
    assert built.table.tolist() == [0, 2] and built.ring == 0
    assert csr_tiles.tiles_for(ip, built) is built
    with pytest.raises(ValueError, match="int32"):
        csr_tiles.tiles_for(ip, csr_tiles.Tiles(torch.tensor([0, 2]), 0, 0,
                                                256))
    with pytest.raises(ValueError, match="Tiles"):
        csr_tiles.tiles_for(ip, built.table)


@pytest.mark.parametrize("backend", ["fused", "spmv"])
def test_engine_builds_the_table_once_for_either_route(backend):
    n = divisible_n(300, 4, 2)
    g = graphs.erdos_renyi(n, 0.05, seed=3)
    eng = engine.compile(algo.pagerank(), g, er_allocation(n, 4, 2),
                         path="sparse", backend=backend, device="cpu")
    np.testing.assert_array_equal(eng._tiles.table.numpy(),
                                  csr_tiles.tile_rows(g.csr.indptr))
    assert eng.with_program(algo.degree_count())._tiles is eng._tiles


@pytest.mark.parametrize("deg,want", [
    ([5, 300, 0, 256, 257], (2, 557)),      # E = 256 at this nnz
    ([0, 0], (0, 0)), ([], (0, 0)), ([3000] * 200, (200, 600_000)),
    ([1024] * 600 + [1025], (1, 1025))])    # E = 1024 at 615,425 entries
def test_long_rows_counts_rows_past_the_kernels_threshold(deg, want):
    assert csr_tiles.long_rows(np.concatenate([[0], np.cumsum(deg)])) == want


def test_some_rows_of_a_graph_are_counted_at_the_graphs_tile_size():
    """A rank's own rows (every fourth row of a graph of 1,232,000 entries,
    E = 2048) hold 308,000 entries, whose own E would be 512: built with
    the graph's E, their table counts no long row and asks no ring, as
    the graph's does, and carries that E to the kernels."""
    deg = np.full(1232, 1000)
    sub = np.concatenate([[0], np.cumsum(deg[::4])])
    E = csr_tiles.tile_entries(int(deg.sum()))
    assert (E, csr_tiles.tile_entries(int(sub[-1]))) == (2048, 512)
    tiles = csr_tiles.tiles_on(sub, "cpu", E)
    assert tiles[1:] == (0, 0, E) and tiles.ring == 0
    np.testing.assert_array_equal(tiles.table.numpy(),
                                  csr_tiles.tile_rows(sub, E))
    own = csr_tiles.tiles_on(sub, "cpu")       # the sub-CSR's own E
    assert own[1:] == (308, 308_000, 512) and own.ring == 1


@pytest.mark.parametrize("model", ["power_law", "er"])
def test_session_sets_the_long_row_gauges(model):
    n = divisible_n(3000, 4, 2)
    g = (graphs.power_law(n, 2.1, seed=3) if model == "power_law"
         else graphs.erdos_renyi(n, 0.004, seed=3))
    prev = obs.set_registry(obs.MetricsRegistry())
    try:
        eng = engine.compile(algo.pagerank(), g, er_allocation(n, 4, 2),
                             path="sparse", backend="fused", device="cpu")
        reg = obs.get_registry()
        got = (reg.get("reduce_long_rows").value,
               reg.get("reduce_long_entries").value)
    finally:
        obs.set_registry(prev)
    deg = np.diff(g.csr.indptr)
    long = deg > csr_tiles.tile_entries(g.csr.nnz)
    assert got == (long.sum(), deg[long].sum()) == csr_tiles.long_rows(
        g.csr.indptr)
    assert got == eng._tiles[1:3]
    # The launch's ring of shared memory: as the session's table carries
    # it, and the same where a wrapper builds the table from indptr.
    indptr = torch.from_numpy(g.csr.indptr.astype(np.int32))
    assert eng._tiles.ring == int(model == "power_law")
    assert csr_tiles.tiles_for(indptr, None).ring == eng._tiles.ring
