"""Port spmv ops (K4 dense, K5 CSR) vs the reference package, on the CPU.

Inputs come from numpy with a seed and go both to the JAX functions (the
Pallas kernel in interpret mode, as `tests/test_kernels.py` runs it) and
to the port's ops, which run the plain PyTorch versions for CPU tensors.
Tolerances are the reference's: float32 rtol 1e-4 / atol 1e-5 and float16
2e-3 for the dense product (the reference's float16 case casts to float32
first, as K4 does, so only the order of the sums differs); rtol 1e-5 for
the CSR row sums of positive values and for PageRank. The wrappers' checks
(device mix, dtype, shape, `bm`, the TPU switches) raise on any device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graphs as r_graphs
from repro.core import algorithms as r_algo
from repro.core import graph_models as r_gm
from repro.kernels.spmv import ops as r_ops
from repro_torch.kernels import _build, csr_tiles
from repro_torch.kernels.spmv import ops, ref
from repro_torch.kernels.spmv import spmv as wrappers

RNG = np.random.default_rng(1234)
TOL = {np.float32: dict(rtol=1e-4, atol=1e-5),
       np.float16: dict(rtol=2e-3, atol=2e-3)}


@pytest.fixture(autouse=True)
def _full_float32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("m,n", [(128, 128), (256, 384), (300, 300),
                                 (100, 250), (1, 128), (128, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_spmv_matches_reference_pallas(m, n, dtype):
    adj = (RNG.random((m, n)) < 0.2).astype(dtype)
    x = RNG.standard_normal(n).astype(dtype)
    want = np.asarray(r_ops.spmv(jnp.array(adj), jnp.array(x)))
    got = ops.spmv(torch.from_numpy(adj), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (m,)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("bm,bk", [(64, 64), (128, 256), (256, 128)])
def test_spmv_block_shape_sweep(bm, bk):
    adj = (RNG.random((512, 512)) < 0.1).astype(np.float32)
    x = RNG.standard_normal(512).astype(np.float32)
    want = np.asarray(r_ops.spmv(jnp.array(adj), jnp.array(x), bm=bm, bk=bk))
    got = ops.spmv(torch.from_numpy(adj), torch.from_numpy(x), bm=bm, bk=bk)
    np.testing.assert_allclose(got.numpy(), want, **TOL[np.float32])
    # bm / bk are validated and change nothing in the port's result.
    base = ops.spmv(torch.from_numpy(adj), torch.from_numpy(x))
    assert torch.equal(got, base)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_pagerank_step_matches_engine_oracle(dtype):
    g = r_gm.erdos_renyi(200, 0.1, seed=5)
    prog = r_algo.pagerank()
    want = r_algo.reference_run(prog, g, 1)
    adj = torch.from_numpy(g.adj.astype(np.float32)).to(dtype)
    got = ops.pagerank_step(adj, torch.from_numpy(prog.init(g)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    jax_step = np.asarray(r_ops.pagerank_step(
        jnp.array(g.adj, jnp.float32), jnp.array(prog.init(g))))
    np.testing.assert_allclose(got.numpy(), jax_step, rtol=1e-5, atol=1e-7)
    # the plain version agrees too
    np.testing.assert_allclose(
        ref.pagerank_step(adj, torch.from_numpy(prog.init(g))).numpy(), want,
        rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("bm", [32, 128])
@pytest.mark.parametrize("n", [37, 200])
def test_spmv_csr_rows_matches_reference(n, bm):
    g = r_graphs.erdos_renyi(n, 0.08, seed=n)
    indptr, indices = g.csr.indptr, g.csr.indices
    c = RNG.random((n, 3)).astype(np.float32) + 0.01
    for b in range(3):
        want = r_ops.spmv_csr_rows(indptr, indices, c[:, b], n,
                                   rows=g.csr.rows, bm=bm)
        got = ops.spmv_csr_rows(indptr, indices, c[:, b], n, bm=bm)
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
        # [n, 3] payloads: column b of one call equals the [n] run of b.
        got3 = ops.spmv_csr_rows(torch.from_numpy(indptr),
                                 torch.from_numpy(indices),
                                 torch.from_numpy(c), n, bm=bm)
        assert got3.shape == (n, 3)
        assert torch.equal(got3[:, b], got)
    empty = np.diff(indptr) == 0
    if empty.any():
        assert (got.numpy()[empty] == 0).all()


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("n", [37, 200])
def test_spmv_csr_sequential_plain_version_matches_reference(n, B):
    """K5's sequential plain version (what the card's K5 is held bitwise
    against) within rtol 1e-5 of the reference's `spmv_csr_rows` on
    positive values, column by column, and with `tiles` passed through
    `ops.spmv_csr_rows` unchanged in result."""
    g = r_graphs.erdos_renyi(n, 0.08, seed=n + B)
    indptr, indices = g.csr.indptr, g.csr.indices
    c = RNG.random((n, B) if B > 1 else n).astype(np.float32) + 0.01
    got = ref.spmv_csr_seq(*(torch.from_numpy(a.astype(np.int32))
                             for a in (indptr, indices)), torch.from_numpy(c))
    for b in range(B):
        col = c if B == 1 else c[:, b]
        want = r_ops.spmv_csr_rows(indptr, indices, col, n, rows=g.csr.rows)
        np.testing.assert_allclose(got.numpy() if B == 1 else got[:, b].numpy(),
                                   want, rtol=1e-5, atol=0)
    tiles = csr_tiles.tiles_on(indptr, "cpu", 16)
    np.testing.assert_allclose(
        ops.spmv_csr_rows(indptr, indices, c, n, tiles=tiles).numpy(),
        got.numpy(), rtol=1e-5, atol=0)


@pytest.mark.parametrize("B", [1, 4])
def test_spmv_csr_sequential_plain_version_sums_long_rows_in_chunks(B):
    """A row of 3E + 5 entries (E = tile_entries(nnz)) among short rows:
    `spmv_csr_seq` sums it in chunks of LONG_CHUNK from its first entry,
    then the chunk sums in turn (bitwise a float32 loop in that order),
    the short rows in CSR order, all within rtol 1e-5 of float64."""
    rng = np.random.default_rng(40 + B)
    E, S = csr_tiles.MIN_TILE_ENTRIES, csr_tiles.LONG_CHUNK
    deg = rng.integers(0, 15, size=200)
    deg[77] = 3 * E + 5
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    assert csr_tiles.tile_entries(int(indptr[-1])) == E
    indices = rng.integers(0, 200, size=indptr[-1]).astype(np.int32)
    c = (rng.random((200, B) if B > 1 else 200) + 0.01).astype(np.float32)
    got = ref.spmv_csr_seq(torch.from_numpy(indptr), torch.from_numpy(indices),
                           torch.from_numpy(c)).numpy()
    vals = c[indices]

    def run(row):
        acc = row[0].copy()
        for v in row[1:]:
            acc = (acc + v).astype(np.float32)
        return acc

    want = np.zeros_like(got)
    for i in range(200):
        row = vals[indptr[i]:indptr[i + 1]]
        if deg[i] > E:
            want[i] = run(np.stack([run(row[k:k + S])
                                    for k in range(0, deg[i], S)]))
        elif deg[i]:
            want[i] = run(row)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    exact = np.add.reduceat(vals.astype(np.float64), indptr[:-1])
    exact[deg == 0] = 0
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=0)


def test_spmv_csr_empty_rows_and_one_long_row():
    # rows 0 and 3 empty, row 2 holds every vertex
    n = 6
    indptr = np.array([0, 0, 2, 8, 8, 9, 10], dtype=np.int32)
    indices = np.array([1, 4, 0, 1, 2, 3, 4, 5, 2, 0], dtype=np.int32)
    c = np.arange(1, n + 1, dtype=np.float32)
    got = wrappers.spmv_csr(torch.from_numpy(indptr),
                            torch.from_numpy(indices), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(),
                                  [0, 7, 21, 0, 3, 1])


def test_cpu_runs_launch_nothing():
    before = dict(_build.LAUNCHES)
    adj = torch.ones((4, 4))
    ops.spmv(adj, torch.ones(4))
    ops.spmv_csr_rows(np.array([0, 1, 2]), np.array([1, 0]),
                      np.ones(2, np.float32), 2)
    assert dict(_build.LAUNCHES) == before


def _csr():
    return (torch.tensor([0, 1, 2], dtype=torch.int32),
            torch.tensor([1, 0], dtype=torch.int32),
            torch.ones(2, dtype=torch.float32))


@pytest.mark.parametrize("case,exc,match", [
    ("dense_mix", ValueError, "share one device"),
    ("csr_mix", ValueError, "share one device"),
    ("dense_meta", ValueError, "unsupported device"),
    ("adj_int", TypeError, "adj must be float32 or float16"),
    ("x_f64", TypeError, "x must be float32 or float16"),
    ("adj_1d", ValueError, r"adj must be \[m, n\]"),
    ("x_shape", ValueError, "x must have shape"),
    ("adj_strided", ValueError, "adj must be contiguous"),
    ("indptr_i64", TypeError, "indptr must be torch.int32"),
    ("c_f64", TypeError, "c must be torch.float32"),
    ("indptr_shape", ValueError, "indptr must have shape"),
    ("c_3d", ValueError, r"c must be \[n\] or \[n, B\]"),
    ("bm_3", ValueError, "power of two"),
    ("bm_512", ValueError, "power of two"),
    ("bm_0", ValueError, "power of two"),
    ("rows_bm", ValueError, "power of two"),
    ("tile_bk", ValueError, "bk must be a positive int"),
    ("spmv_interpret", TypeError, "interpret"),
    ("spmv_use_kernel", TypeError, "use_kernel"),
    ("rows_interpret", TypeError, "interpret"),
    ("step_interpret", TypeError, "interpret"),
    ("rows_n", ValueError, "n=3 needs"),
])
def test_wrapper_errors(case, exc, match):
    adj, x = torch.ones((3, 4)), torch.ones(4)
    indptr, indices, c = _csr()
    meta = torch.empty(4, device="meta")
    calls = {
        "dense_mix": lambda: wrappers.spmv_dense(adj, meta),
        "csr_mix": lambda: wrappers.spmv_csr(indptr, indices,
                                             torch.empty(2, device="meta")),
        "dense_meta": lambda: wrappers.spmv_dense(
            torch.empty((3, 4), device="meta"), meta),
        "adj_int": lambda: wrappers.spmv_dense(adj.int(), x),
        "x_f64": lambda: wrappers.spmv_dense(adj, x.double()),
        "adj_1d": lambda: wrappers.spmv_dense(x, x),
        "x_shape": lambda: wrappers.spmv_dense(adj, torch.ones(5)),
        "adj_strided": lambda: wrappers.spmv_dense(
            torch.ones((4, 3)).t(), x),
        "indptr_i64": lambda: wrappers.spmv_csr(indptr.long(), indices, c),
        "c_f64": lambda: wrappers.spmv_csr(indptr, indices, c.double()),
        "indptr_shape": lambda: wrappers.spmv_csr(indptr[:2], indices, c),
        "c_3d": lambda: wrappers.spmv_csr(indptr, indices, c[:, None, None]),
        "bm_3": lambda: wrappers.spmv_csr(indptr, indices, c, bm=3),
        "bm_512": lambda: wrappers.spmv_csr(indptr, indices, c, bm=512),
        "bm_0": lambda: wrappers.spmv_csr(indptr, indices, c, bm=0),
        "rows_bm": lambda: ops.spmv_csr_rows(indptr, indices, c, 2, bm=100),
        "tile_bk": lambda: ops.spmv(adj, x, bk=0),
        "spmv_interpret": lambda: ops.spmv(adj, x, interpret=True),
        "spmv_use_kernel": lambda: ops.spmv(adj, x, use_kernel=False),
        "rows_interpret": lambda: ops.spmv_csr_rows(indptr, indices, c, 2,
                                                    interpret=True),
        "step_interpret": lambda: ops.pagerank_step(torch.ones((4, 4)), x,
                                                    interpret=True),
        "rows_n": lambda: ops.spmv_csr_rows(indptr, indices, c, 3),
    }
    with pytest.raises(exc, match=match):
        calls[case]()
