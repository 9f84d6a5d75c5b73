"""Port gather + segmented reduce (K3, plain version on the CPU) vs the
reference's `algorithms.segment_reduce`.

The port reduces concat(edge_vals, floats(delivered codec words))[gather]
per CSR row. `min` must be bitwise equal to `np.minimum.reduceat`; `sum`
within rtol 1e-5, because `np.add.reduceat` does not add sequentially
while the port's kernel (and `index_add_` on the CPU) does. Empty rows get
the identity; B > 1 payload columns reduce independently.

The sequential plain version (`ref.csr_reduce_seq`, what the card's K3 and
K5 are held bitwise against) is held against the same oracle: min
bitwise (NaN payloads and ties of +-0, where NumPy's vectorised reduction
picks in no fixed order, against a loop of NumPy's rule), sums bitwise
equal to a float32 loop over each row in the kernels' order and, on values
whose partial sums are exact, within rtol 1e-5 of the oracle. The order: a
row of at most E = `csr_tiles.tile_entries(nnz)` entries in CSR order from
its first value; a longer row in chunks of S = `csr_tiles.LONG_CHUNK`
entries from its first, each so, then the chunk results so, left to right.
Rows of E, E + 1, E + S - 1, E + S and 3E + 5 entries are held bitwise
against that loop (short rows against a plain CSR-order loop) and within
rtol 1e-5 of a float64 sum.
"""
import numpy as np
import pytest
import torch

from repro.core.algorithms import segment_reduce as r_segment_reduce
from repro_torch.core import algorithms as t_algo
from repro_torch.core.bitcodec import floats_to_words
from repro_torch.kernels import csr_tiles
from repro_torch.kernels.segment_reduce import ops as t_ops
from repro_torch.kernels.segment_reduce import ref as t_ref

SUM_RTOL = 1e-5


def _case(seed, n, avg_deg, M, B, empty_frac=0.2):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 2 * avg_deg + 1, size=n)
    deg[rng.random(n) < empty_frac] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    nnz = int(indptr[-1])
    gather = rng.permutation(nnz + M)[:nnz]
    shape = lambda m: (m, B) if B > 1 else (m,)  # noqa: E731
    ev = rng.standard_normal(shape(nnz)).astype(np.float32)
    dv = rng.standard_normal(shape(M)).astype(np.float32)
    if B > 1:
        ev[rng.random(ev.shape) < 0.05] = np.inf    # sssp-style infinities
    gathered = np.concatenate([ev, dv])[gather]
    args = (torch.from_numpy(ev),
            torch.from_numpy(floats_to_words(dv).view(np.int32)),
            torch.from_numpy(gather.astype(np.int32)),
            torch.from_numpy(indptr.astype(np.int32)))
    return gathered, indptr, args


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("seed,n,avg_deg,M", [(0, 50, 4, 30), (1, 400, 9, 700),
                                              (2, 7, 0, 5)])
def test_min_bitwise(seed, n, avg_deg, M, B):
    gathered, indptr, args = _case(seed, n, avg_deg, M, B)
    want = r_segment_reduce(np.minimum, gathered, indptr, np.inf)
    got = t_ops.segment_reduce(*args, "min", np.inf).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("seed,n,avg_deg,M", [(3, 50, 4, 30), (4, 400, 40, 700),
                                              (5, 7, 0, 5)])
def test_sum_within_tolerance(seed, n, avg_deg, M, B):
    gathered, indptr, args = _case(seed, n, avg_deg, M, B)
    gathered = np.where(np.isfinite(gathered), gathered, 0).astype(np.float32)
    ev = torch.where(torch.isfinite(args[0]), args[0], 0)
    want = r_segment_reduce(np.add, gathered, indptr, 0.0)
    got = t_ops.segment_reduce(ev, *args[1:], "sum", 0.0).numpy()
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=1e-6)
    assert (got[np.diff(indptr) == 0] == 0).all()


def test_unknown_op_and_device_mix_raise():
    _, _, args = _case(0, 10, 2, 4, 1)
    with pytest.raises(ValueError, match="unknown reduce op"):
        t_ops.segment_reduce(*args, "max", 0.0)
    with pytest.raises(ValueError, match="share one device"):
        t_ops.segment_reduce(args[0].to("meta"), *args[1:], "sum", 0.0)


def test_program_reduce_ops_match_reference_identities():
    for prog in (t_algo.pagerank(), t_algo.degree_count(),
                 t_algo.personalized_pagerank(t_algo.uniform_prefs(4, 2))):
        assert prog.reduce_op == "sum" and prog.identity == 0.0
    for prog in (t_algo.sssp(0), t_algo.connected_components(),
                 t_algo.multi_sssp([0, 1])):
        assert prog.reduce_op == "min" and prog.identity == np.inf


def _run(row, combine):
    """From the first value, combined one value at a time."""
    acc = row[0].copy()
    for v in row[1:]:
        acc = combine(acc, v)
    return acc


def _seq_loop(vals, indptr, combine, chunked=True):
    """Each row in the kernels' order: a row of more than E =
    tile_entries(nnz) entries in runs of S = LONG_CHUNK, then the runs'
    results in turn; any other row (every row, `chunked=False`) as one
    run in CSR order."""
    E, S = csr_tiles.tile_entries(vals.shape[0]), csr_tiles.LONG_CHUNK
    out = np.zeros((indptr.size - 1,) + vals.shape[1:], np.float32)
    for i in range(indptr.size - 1):
        row = vals[indptr[i]:indptr[i + 1]]
        if chunked and row.shape[0] > E:
            out[i] = _run(np.stack([_run(row[k:k + S], combine)
                                    for k in range(0, row.shape[0], S)]),
                          combine)
        elif row.shape[0]:
            out[i] = _run(row, combine)
    return out


def _add(a, v):
    return (a + v).astype(np.float32)


def _np_min(a, v):
    return np.where((a <= v) | np.isnan(a), a, v).astype(np.float32)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("seed,n,avg_deg,M", [(6, 50, 4, 30), (7, 400, 40, 700),
                                              (8, 7, 0, 5), (9, 12, 1500, 90)])
def test_sequential_plain_version_matches_oracle(seed, n, avg_deg, M, B):
    gathered, indptr, args = _case(seed, n, avg_deg, M, B)
    want = r_segment_reduce(np.minimum, gathered, indptr, np.inf)
    got = t_ref.segment_reduce_seq(*args, "min", np.inf).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    finite = np.where(np.isfinite(gathered), gathered, 0).astype(np.float32)
    ev = torch.where(torch.isfinite(args[0]), args[0], 0)
    got = t_ref.segment_reduce_seq(ev, *args[1:], "sum", 0.0).numpy()
    # Bitwise a float32 loop over each row in the kernels' order (rows
    # past E = 256 entries here in chunks).
    seq = _seq_loop(finite, indptr, _add)
    np.testing.assert_array_equal(got.view(np.uint32), seq.view(np.uint32))
    # Against the oracle on values of a 2^-10 grid, whose partial sums are
    # exact in any order (rows of 1,500 standard-normal values cancel, and
    # their order alone moves a sum by ~1e-5).
    grid = np.round(finite * 1024) / 1024
    got = t_ref.csr_reduce_seq(torch.from_numpy(grid), torch.from_numpy(indptr),
                               "sum", 0.0).numpy()
    np.testing.assert_allclose(
        got, r_segment_reduce(np.add, grid, indptr, 0.0), rtol=SUM_RTOL,
        atol=1e-6)


def test_sequential_min_rule_on_nans_and_signed_zeros():
    """NumPy's minimum keeps the accumulator when it is <= the value or
    NaN. Canonical NaNs and infinities come out bitwise the oracle's; on
    ties of +-0 and among NaN payloads NumPy's vectorised reduction picks
    in no fixed order, so there the rule is held against a loop."""
    vals = np.array([2.0, np.nan, 1.0, -np.inf, 3.0, np.nan, np.inf, 1.0,
                     -1.0, np.inf], np.float32)
    indptr = np.array([0, 3, 5, 5, 8, 10])
    got = t_ref.csr_reduce_seq(torch.from_numpy(vals), torch.from_numpy(indptr),
                               "min", np.inf).numpy()
    want = r_segment_reduce(np.minimum, vals, indptr, np.inf)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    vals = np.array([0.0, -0.0, 1.0, -0.0, 0.0, np.nan, 2.0, np.nan, -1.0,
                     3.0, -np.inf, 5.0], np.float32)
    vals.view(np.uint32)[7] = 0x7fc00001                  # another payload
    indptr = np.array([0, 3, 5, 9, 9, 12])
    got = t_ref.csr_reduce_seq(torch.from_numpy(vals), torch.from_numpy(indptr),
                               "min", np.inf).numpy()
    want = _seq_loop(vals, indptr, _np_min)
    want[np.diff(indptr) == 0] = np.inf
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.view(np.uint32)[:3].tolist() == [0, 0x80000000, 0x7fc00000]
    with pytest.raises(ValueError, match="unknown reduce op"):
        t_ref.csr_reduce_seq(torch.from_numpy(vals), torch.from_numpy(indptr),
                             "max", 0.0)


LONG = {"E": lambda E, S: E, "E+1": lambda E, S: E + 1,
        "E+S-1": lambda E, S: E + S - 1, "E+S": lambda E, S: E + S,
        "3E+5": lambda E, S: 3 * E + 5}


def _long_case(seed, length, B):
    """300 rows of 0..20 entries around one row of `length`(E, S) entries,
    E = tile_entries(nnz) = 256 here; positive values (PageRank-like), so
    a float64 sum is a fair yardstick and any other order moves the bits."""
    rng = np.random.default_rng(seed)
    E, S = csr_tiles.MIN_TILE_ENTRIES, csr_tiles.LONG_CHUNK
    deg = rng.integers(0, 21, size=300)
    deg[150] = length(E, S)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    assert csr_tiles.tile_entries(int(indptr[-1])) == E
    shape = (int(indptr[-1]), B) if B > 1 else (int(indptr[-1]),)
    return indptr, (rng.random(shape) + 0.01).astype(np.float32), E


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("op", ["sum", "min"])
@pytest.mark.parametrize("length", list(LONG), ids=list(LONG))
def test_long_rows_in_chunks_short_rows_in_csr_order(length, op, B):
    indptr, vals, E = _long_case(len(length) + B, LONG[length], B)
    combine = _add if op == "sum" else _np_min
    got = t_ref.csr_reduce_seq(torch.from_numpy(vals),
                               torch.from_numpy(indptr), op, 0.0).numpy()
    long = np.diff(indptr) > E
    assert long.sum() == (length not in ("E",))
    plain = _seq_loop(vals, indptr, combine, chunked=False)
    np.testing.assert_array_equal(got[~long].view(np.uint32),
                                  plain[~long].view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _seq_loop(vals, indptr, combine).view(np.uint32))
    if op == "sum":
        want = np.add.reduceat(vals.astype(np.float64), indptr[:-1])
        want[np.diff(indptr) == 0] = 0
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=0)
    else:
        want = r_segment_reduce(np.minimum, vals, indptr, 0.0)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_long_row_min_keeps_the_first_nan_and_the_first_zero():
    """On rows of 3E + 5 entries (chunks of S) the min rule picks what a
    loop over the row in CSR order picks: the first NaN's payload, and of
    +-0 ties the first zero, whichever chunk holds it."""
    E, S = csr_tiles.MIN_TILE_ENTRIES, csr_tiles.LONG_CHUNK
    L = 3 * E + 5
    rng = np.random.default_rng(5)
    vals = (rng.random(3 * L) + 1.0).astype(np.float32)
    bits = vals.view(np.uint32)
    bits[2 * S + 3] = 0x7fc00001                   # row 0: two NaN payloads
    bits[5 * S] = 0x7fc00002
    vals[L + S + 1] = -0.0                         # row 1: -0 first, then +0
    vals[L + 4 * S - 1] = 0.0
    vals[2 * L + 7] = 0.0                          # row 2: +0 first, then -0
    vals[2 * L + 3 * S] = -0.0
    indptr = np.array([0, L, 2 * L, 3 * L])
    assert csr_tiles.tile_entries(vals.size) == E
    got = t_ref.csr_reduce_seq(torch.from_numpy(vals), torch.from_numpy(indptr),
                               "min", np.inf).numpy()
    assert got.view(np.uint32).tolist() == [0x7fc00001, 0x80000000, 0]
    plain = _seq_loop(vals, indptr, _np_min, chunked=False)
    np.testing.assert_array_equal(got.view(np.uint32), plain.view(np.uint32))


def test_long_chunk_fits_every_tile_size():
    S = csr_tiles.LONG_CHUNK
    assert 16 <= S <= 64 and S & (S - 1) == 0
    assert csr_tiles.MIN_TILE_ENTRIES % S == 0
