"""Port kernels and session on the card (skipped without a CUDA device).

Run on a machine with an NVIDIA GPU (no JAX needed; this file imports only
the port):

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each CUDA kernel is held against its plain PyTorch version on the same
device tensors (K1, K2 and K3-min bitwise, K3-sum within rtol 1e-5; K4 at
float32 rtol 1e-4 / atol 1e-5 and float16 2e-3, K5 within rtol 1e-5 and
bitwise repeatable), and small coded and spmv sessions against the NumPy
oracle. Whether a card exists is decided inside the `cuda` fixture, never
at import time.
"""
import numpy as np
import pytest
import torch

from repro_torch import graphs
from repro_torch.core import algorithms as algo
from repro_torch.core import engine
from repro_torch.core.allocation import divisible_n, er_allocation
from repro_torch.kernels import _build
from repro_torch.kernels.segment_reduce import ops as sr
from repro_torch.kernels.segment_reduce import ref as sr_ref
from repro_torch.kernels.spmv import ops as spmv_ops
from repro_torch.kernels.spmv import ref as spmv_ref
from repro_torch.kernels.spmv import spmv as spmv_k
from repro_torch.kernels.xor_code import ref as xref
from repro_torch.kernels.xor_code import xor_code as xc


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 plain spmv
    return torch.device("cuda", torch.cuda.current_device())


def _session(dev, n=4000):
    n = divisible_n(n, 4, 2)
    g = graphs.erdos_renyi(n, 8.0 / n, seed=5)
    return g, engine.compile(algo.pagerank(), g, er_allocation(n, 4, 2),
                             device=dev)


@pytest.mark.parametrize("B", [1, 4])
def test_kernels_match_plain_versions(cuda, B):
    g, eng = _session(cuda)
    state = torch.rand((g.n, B) if B > 1 else (g.n,), device=cuda)
    ev = algo.pagerank().map_edge_values_t(eng._dg, state).contiguous()
    src, t = ev.view(torch.int32), eng.fused.tables
    enc = (src, t["loc_e"], t["enc_l"], t["enc_shift"], t["enc_mask"])
    buf = xc.xor_encode_gather(*enc)
    assert torch.equal(buf, xref.xor_encode_gather(*enc))
    dec = (src, t["loc_e"], buf, t["dec_s"], t["dec_w"], t["dec_mask"],
           t["dec_shift"], t["strip_l"], t["strip_shift"], t["strip_mask"],
           t["ptr"])
    words = xc.xor_decode_gather(*dec)
    assert torch.equal(words, xref.xor_decode_gather(*dec))
    args = (ev, words, eng._gather, eng._indptr)
    mn = sr.segment_reduce(*args, "min", float("inf"))
    assert torch.equal(mn, sr_ref.segment_reduce(*args, "min", float("inf")))
    torch.testing.assert_close(sr.segment_reduce(*args, "sum", 0.0),
                               sr_ref.segment_reduce(*args, "sum", 0.0),
                               rtol=1e-5, atol=1e-6)


def test_session_matches_oracle_and_launches_kernels(cuda):
    g, eng = _session(cuda)
    _build.LAUNCHES.clear()
    res = eng.run(10)
    sssp = eng.with_program(algo.sssp(0)).run(10)
    torch.cuda.synchronize()
    for name in ("xor_encode", "xor_decode", "segment_reduce"):
        assert _build.LAUNCHES[name] == 20
    np.testing.assert_allclose(res.state.cpu().numpy(),
                               algo.reference_run(algo.pagerank(), g, 10),
                               rtol=1e-5, atol=0)
    want = algo.reference_run(algo.sssp(0), g, 10)
    np.testing.assert_array_equal(sssp.state.cpu().numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_launch_errors_raise(cuda):
    rows = torch.zeros((2, 3, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        xc.xor_encode_dense(rows.float(), torch.ones((2, 3), dtype=torch.bool,
                                                     device=cuda))


@pytest.mark.parametrize("m,n", [(1, 128), (128, 1), (300, 300), (257, 1023),
                                 (64, 4099), (512, 512)])
@pytest.mark.parametrize("a_dt,x_dt", [(torch.float32, torch.float32),
                                       (torch.float16, torch.float16),
                                       (torch.float16, torch.float32),
                                       (torch.float32, torch.float16)])
def test_spmv_dense_matches_plain_version(cuda, m, n, a_dt, x_dt):
    rng = np.random.default_rng(m * n)
    adj = torch.from_numpy(rng.random((m, n)) < 0.2).to(cuda, a_dt)
    x = torch.from_numpy(rng.standard_normal(n)).to(cuda, x_dt)
    got = spmv_k.spmv_dense(adj, x)
    want = spmv_ref.spmv(adj, x)
    half = torch.float16 in (a_dt, x_dt)
    torch.testing.assert_close(got, want, rtol=2e-3 if half else 1e-4,
                               atol=2e-3 if half else 1e-5)


def _random_csr(rng, n, B, dev):
    deg = rng.integers(0, 17, size=n)
    deg[rng.random(n) < 0.2] = 0                       # empty rows
    deg[n // 2] = 5000                                 # one long row
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    # Standard-normal values on a 2^-10 grid: every partial sum is exact
    # in float32, so the long row's sums cannot differ by summation order.
    c = np.round(rng.standard_normal((n, B) if B > 1 else n) * 1024) / 1024
    return [torch.from_numpy(a).to(dev)
            for a in (indptr, indices, c.astype(np.float32))]


@pytest.mark.parametrize("bm", [1, 8, 128, 256])
@pytest.mark.parametrize("B", [1, 4])
def test_spmv_csr_matches_plain_version_and_repeats(cuda, B, bm):
    indptr, indices, c = _random_csr(np.random.default_rng(B + bm), 3001, B,
                                     cuda)
    got = spmv_k.spmv_csr(indptr, indices, c, bm=bm)
    torch.testing.assert_close(got, spmv_ref.spmv_csr(indptr, indices, c),
                               rtol=1e-5, atol=1e-6)
    again = spmv_k.spmv_csr(indptr, indices, c, bm=bm)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("mode", ["single", "uncoded", "coded", "coded-fast"])
def test_spmv_session_matches_oracle_and_launches_k5(cuda, mode):
    n = divisible_n(4000, 4, 2)
    g = graphs.erdos_renyi(n, 8.0 / n, seed=5)
    eng = engine.compile(algo.pagerank(), g, er_allocation(n, 4, 2), mode,
                         backend="spmv", device=cuda)
    _build.LAUNCHES.clear()
    res = eng.run(10)
    deg = eng.with_program(algo.degree_count()).run(1)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["spmv_csr"] == 11
    np.testing.assert_allclose(res.state.cpu().numpy(),
                               algo.reference_run(algo.pagerank(), g, 10),
                               rtol=1e-5, atol=0)
    want = algo.reference_run(algo.degree_count(), g, 1)
    np.testing.assert_array_equal(deg.state.cpu().numpy(), want)
    assert res.shuffle_bits == 10 * eng.schedule_bits


def test_dense_pagerank_step_on_the_card(cuda):
    g = graphs.erdos_renyi(700, 0.05, seed=5)
    csr = g.csr
    for dt in (torch.float32, torch.float16):
        adj = torch.zeros((g.n, g.n), dtype=dt, device=cuda)
        adj[torch.from_numpy(csr.rows.astype(np.int64)).to(cuda),
            torch.from_numpy(csr.indices.astype(np.int64)).to(cuda)] = 1
        rank = torch.as_tensor(algo.pagerank().init(g), device=cuda)
        _build.LAUNCHES.clear()
        for _ in range(10):
            rank = spmv_ops.pagerank_step(adj, rank)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["spmv_dense"] == 10
        np.testing.assert_allclose(
            rank.cpu().numpy(), algo.reference_run(algo.pagerank(), g, 10),
            rtol=1e-5, atol=0)
