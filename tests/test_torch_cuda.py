"""Port kernels and session on the card (skipped without a CUDA device).

Run on a machine with an NVIDIA GPU (no JAX needed; this file imports only
the port):

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each CUDA kernel is held against its plain PyTorch version on the same
device tensors (K1, K2 and K3-min bitwise, K3-sum within rtol 1e-5), and a
small coded session against the NumPy oracle. Whether a card exists is
decided inside the `cuda` fixture, never at import time.
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
from repro_torch.kernels.xor_code import ref as xref
from repro_torch.kernels.xor_code import xor_code as xc


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
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
