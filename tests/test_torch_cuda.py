"""Port kernels and session on the card (skipped without a CUDA device).

Run on a machine with an NVIDIA GPU (no JAX needed; this file imports only
the port):

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each CUDA kernel is held against its plain PyTorch version on the same
device tensors (the packed K1 and K2 at r = 2 and at the runtime-r
instance r = 5, 33 and 64, K1's general form against the packed K1, and
r = 65 refused with the CPU's message; K3 and K5, the CSR-streaming body,
bitwise against the sequential plain version at B = 1, 2, 4, 5 with empty
rows, ragged tiles and a row longer than a tile, K3-min also against the
scatter plain version, both bitwise repeatable and K5 the same for every
`bm`; K4 at float32 rtol 1e-4 / atol 1e-5 and float16 2e-3; K6 within
rtol 1e-4 and atol 1e-4 * max|plain|, in float32 and on the serve path's
bf16 inputs with B / C shared by the heads, one shot and staged in parts
up to Q = 256, K7 bitwise; K1's dense form through the column routes at
C = 0, r = 64 and r = 65, refused), small coded and spmv sessions (ER, a
power-law graph with a row longer than a tile, r = 33 and 64) and
`backend="numpy"` sessions in every mode and path against the NumPy
oracle, the plan executor's coded words with every codec word's top bit
set bitwise the NumPy executor's on every XOR route, the plan kernels
(`xor_encode_plan` / `xor_decode_plan`) bitwise their plain versions on
random tables and on plans' tables at r = 1..5, 33 and 64 with their
launch counts and launch errors raising, K2 with direct words (the
two-level Shuffle's intra-rack deliveries) bitwise its plain version at
r = 1, 2, 3, 5 and 33, a two-level session (`Topology(4, 2)` and
`(2, 4)`) on backend="fused" bitwise backend="numpy" and the host plan,
the plan kernels on a repaired plan (`fail`: dead receivers and senders,
demoted pairs) and the packed K1 / K2 on a rebound session's tables
(`update`, and with a sender's columns and a receiver's deliveries taken
out), the packed K1 / K2 on each rank's rows of a P-rank group's tables
(P = 2 and 4, K = 4 and 8, no process group needed) and the fused route on
a one-rank NCCL group bitwise the virtual route, and the reduced mamba2-370m
served on the card (the kernel prefill
against the plain chunked prefill and the decode loop). Whether a card
exists is decided inside the `cuda` fixture, never at import time.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs, graphs
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import algorithms as algo
from repro_torch.core import engine
from repro_torch.core.allocation import divisible_n, er_allocation
from repro_torch.core.fused_shuffle import _i32
from repro_torch.kernels import _build, csr_tiles
from repro_torch.kernels.segment_reduce import ops as sr
from repro_torch.kernels.segment_reduce import ref as sr_ref
from repro_torch.kernels.spmv import ops as spmv_ops
from repro_torch.kernels.spmv import ref as spmv_ref
from repro_torch.kernels.spmv import spmv as spmv_k
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_k
from repro_torch.kernels.xor_code import ref as xref
from repro_torch.kernels.xor_code import xor_code as xc
from repro_torch.launch import serve
from repro_torch.models import decode as dec
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_params


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 plain spmv
    return torch.device("cuda", torch.cuda.current_device())


def _session(dev, n=4000, K=4, r=2):
    n = divisible_n(n, K, r)
    g = graphs.erdos_renyi(n, 8.0 / n, seed=5)
    return g, engine.compile(algo.pagerank(), g, er_allocation(n, K, r),
                             path="sparse", backend="fused", device=dev)


def _hold_packed(dev, g, eng, B):
    """Packed K1/K2 bitwise against their plain versions on the session's
    tables, and K1's general form on the unpacked tables writing the same
    buffers. Returns the Map output and the delivered words."""
    state = torch.rand((g.n, B) if B > 1 else (g.n,), device=dev)
    ev = algo.pagerank().map_edge_values_t(eng._dg, state).contiguous()
    src, t, fx = ev.view(torch.int32), eng.fused.tables, eng.fused
    enc = (src, t["enc_e"], t["enc_code"], t["book"])
    buf = xc.xor_encode_packed(*enc)
    assert torch.equal(buf, xref.xor_encode_packed(*enc))
    dec = (src, buf, t["dec_pos"], t["dec_code"], t["strip_e"],
           t["strip_code"], t["book"], t["ptr"])
    words = xc.xor_decode_packed(*dec, total=fx.M)
    assert torch.equal(words, xref.xor_decode_packed(*dec))
    s = fx.sched
    general = [_i32(a, dev) for a in (s.loc_e, s.enc_l, s.enc_shift,
                                      s.enc_mask)]
    assert torch.equal(xc.xor_encode_gather(src, *general), buf)
    return ev, words


@pytest.mark.parametrize("B", [1, 4])
def test_kernels_match_plain_versions(cuda, B):
    g, eng = _session(cuda)
    ev, words = _hold_packed(cuda, g, eng, B)
    args = (ev, words, eng._gather, eng._indptr)
    mn = sr.segment_reduce(*args, "min", float("inf"))
    assert torch.equal(mn, sr_ref.segment_reduce(*args, "min", float("inf")))
    torch.testing.assert_close(sr.segment_reduce(*args, "sum", 0.0),
                               sr_ref.segment_reduce(*args, "sum", 0.0),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B", [1, 4])
def test_packed_kernels_at_runtime_r(cuda, B):
    """r = 5 runs the runtime-r instance of the packed K1/K2."""
    g, eng = _session(cuda, n=2000, K=6, r=5)
    assert eng.fused.sched.r == 5
    _hold_packed(cuda, g, eng, B)
    np.testing.assert_allclose(eng.run(10).state.cpu().numpy(),
                               algo.reference_run(algo.pagerank(), g, 10),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("K,r", [(34, 33), (64, 64)])
def test_sessions_past_32_segments(cuda, K, r):
    """r > 32 runs the runtime-r instance with a book of r + 2 <= 66 codes:
    K1/K2 bitwise their plain versions, delivered words bitwise the NumPy
    executor, sssp bitwise the oracle."""
    n = divisible_n(2 * K, K, r)
    g = graphs.erdos_renyi(n, 0.1, seed=K)
    eng = engine.compile(algo.sssp(0), g, er_allocation(n, K, r),
                         path="sparse", backend="fused", device=cuda)
    assert eng.fused.sched.r == r
    for B in (1, 3):
        _hold_packed(cuda, g, eng, B)
    ev = np.random.default_rng(r).standard_normal(g.csr.nnz).astype(np.float32)
    want = eng.plan.execute_coded_sparse(ev, eng.tables)
    got = eng.fused.execute(ev)
    np.testing.assert_array_equal(got.values.view(np.uint32),
                                  want.values.view(np.uint32))
    _build.LAUNCHES.clear()
    res = eng.run(10)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["xor_encode"] == _build.LAUNCHES["xor_decode"] == 10
    oracle = algo.reference_run(algo.sssp(0), g, 10)
    np.testing.assert_array_equal(res.state.cpu().numpy().view(np.uint32),
                                  oracle.view(np.uint32))


def test_packed_kernels_refuse_r_past_64(cuda):
    from repro_torch.core.fused_shuffle import code_book

    K, W, Dmax, r = 2, 3, 2, 65
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=cuda)  # noqa: E731
    u8 = lambda *s: torch.zeros(s, dtype=torch.uint8, device=cuda)  # noqa: E731
    book = torch.from_numpy(code_book(r).view(np.int32)).to(cuda)
    msg = r"^r = 65: the packed kernels take 1 <= r <= 64$"
    with pytest.raises(ValueError, match=msg):
        xc.xor_encode_packed(z(5), z(K, W, r), u8(K, W, r), book)
    with pytest.raises(ValueError, match=msg):
        xc.xor_decode_packed(z(5), z(K, W + 1), z(K, Dmax, r), u8(K, Dmax, r),
                             z(K, Dmax, r, r - 1), u8(K, Dmax, r, r - 1), book,
                             z(K + 1))


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


def _random_direct_tables(rng, dev, K, W, nnz, Dmax, r, B):
    """Random packed K2 tables with direct entries (the sentinel nnz and
    entries past it included), deliveries per receiver 0..Dmax."""
    from repro_torch.core.fused_shuffle import code_book

    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    code = lambda shape: up(rng.integers(0, r + 2, size=shape)  # noqa: E731
                            .astype(np.uint8))
    ints = lambda hi, shape: up(rng.integers(0, hi, size=shape)  # noqa: E731
                                .astype(np.int32))
    counts = rng.integers(0, Dmax + 1, size=K)
    src = up(rng.integers(0, 2 ** 32, size=(nnz, B) if B > 1 else (nnz,),
                          dtype=np.uint32).view(np.int32))
    book = up(code_book(r).view(np.int32))
    buf = xc.xor_encode_packed(src, ints(nnz + 1, (K, W, r)), code((K, W, r)),
                               book)
    dec = (ints(K * (W + 1), (K, Dmax, r)), code((K, Dmax, r)),
           ints(nnz + 1, (K, Dmax, r, r - 1)), code((K, Dmax, r, r - 1)),
           book, up(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)))
    return src, buf, dec, ints(nnz + 3, (K, Dmax))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("r", [1, 2, 3, 5, 33])
def test_k2_direct_matches_plain_version(cuda, r, B):
    """K2 with direct_e bitwise its plain version, counted apart from the
    flat K2, whose words it ORs its direct words into."""
    rng = np.random.default_rng(r * 10 + B)
    src, buf, dec, direct = _random_direct_tables(rng, cuda, 5, 41, 700, 37,
                                                  r, B)
    _build.LAUNCHES.clear()
    got = xc.xor_decode_packed(src, buf, *dec, direct_e=direct)
    flat = xc.xor_decode_packed(src, buf, *dec)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["xor_decode_direct"] == 1
    assert _build.LAUNCHES["xor_decode"] == 1
    assert torch.equal(got, xref.xor_decode_packed(src, buf, *dec,
                                                   direct_e=direct))
    assert torch.equal(flat, xref.xor_decode_packed(src, buf, *dec))
    assert torch.equal(got & ~flat, got ^ flat)        # only bits ORed in


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_hierarchical_fused_session_matches_numpy(cuda, shape):
    """The two-level session on the card: backend="fused" (K1 over the rack
    buffers, K2 with direct words) delivers the words of backend="numpy"
    (the plan kernels at the rack level) and of the host plan, bitwise;
    states bitwise equal, the same bits, each route's kernels launched."""
    from repro_torch.core.bitcodec import floats_to_words, t_words_to_np
    from repro_torch.launch.mesh import Topology

    n = divisible_n(3000, 8, 2)
    g = graphs.erdos_renyi(n, 8.0 / n, seed=3)
    alloc = er_allocation(n, 8, 2)
    sess = {b: engine.compile(algo.pagerank(), g, alloc, "coded", path="sparse",
                              backend=b, topology=Topology(*shape), device=cuda)
            for b in ("fused", "numpy")}
    hp = sess["fused"].hplan
    ev = algo.pagerank().map_edge_values_t(
        sess["fused"]._dg, torch.rand(g.n, device=cuda)).contiguous()
    want = floats_to_words(hp.execute_coded_sparse(
        ev.cpu().numpy(), hp.edge_tables(g.csr, alloc)).values)
    np.testing.assert_array_equal(t_words_to_np(sess["fused"].fused.exchange(ev)),
                                  want)
    np.testing.assert_array_equal(t_words_to_np(sess["numpy"].dplan.words(ev)),
                                  want)
    kernels = {"fused": ("xor_encode", "xor_decode_direct", "segment_reduce"),
               "numpy": ("xor_encode_plan", "xor_decode_plan", "segment_reduce")}
    for prog in (algo.pagerank(), algo.sssp(0)):
        res = {}
        for b, eng in sess.items():
            _build.LAUNCHES.clear()
            res[b] = eng.with_program(prog).run(5)
            torch.cuda.synchronize()
            for name in kernels[b]:
                assert _build.LAUNCHES[name] == 5, (b, name)
        assert torch.equal(res["fused"].state.view(torch.int32),
                           res["numpy"].state.view(torch.int32))
        assert res["fused"].shuffle_bits == res["numpy"].shuffle_bits == 5 * (
            hp.inter_rack_bits + hp.intra_rack_bits)


@pytest.mark.parametrize("mode,path", [
    ("single", "auto"), ("uncoded", "auto"), ("coded", "auto"),
    ("coded-fast", "auto"), ("single", "dense"), ("uncoded", "dense"),
    ("coded", "dense"), ("coded-fast", "dense"), ("coded-ref", "dense")])
def test_numpy_backend_modes_on_the_card(cuda, mode, path):
    """backend="numpy" (the plan executors on the card) against the NumPy
    oracle of its path: sssp bitwise, pagerank within rtol 1e-5, exact
    bits; the coded route launches the plan encode and decode once each
    per iteration and K1's dense form never, the sparse path K3."""
    n = divisible_n(400, 4, 2)
    g = graphs.erdos_renyi(n, 0.03, seed=3)
    alloc = er_allocation(n, 4, 2)
    eng = engine.compile(algo.pagerank(), g, alloc, mode, path=path,
                         backend="numpy", device=cuda)
    _build.LAUNCHES.clear()
    res = eng.run(5)
    sssp = eng.with_program(algo.sssp(0)).run(5)
    torch.cuda.synchronize()
    oracle = "dense" if path == "dense" else "sparse"
    np.testing.assert_allclose(
        res.state.cpu().numpy(),
        algo.reference_run(algo.pagerank(), g, 5, path=oracle),
        rtol=1e-5, atol=0)
    want = algo.reference_run(algo.sssp(0), g, 5, path=oracle)
    np.testing.assert_array_equal(sssp.state.cpu().numpy().view(np.uint32),
                                  want.view(np.uint32))
    if mode in ("coded", "coded-fast", "uncoded"):
        assert res.shuffle_bits == 5 * engine._plan_bits(eng.plan, mode)
    if mode == "coded":
        assert _build.LAUNCHES["xor_encode_plan"] == 10
        assert _build.LAUNCHES["xor_decode_plan"] == 10
        assert _build.LAUNCHES["xor_encode_dense"] == 0
    if path == "auto":
        assert _build.LAUNCHES["segment_reduce"] == 10


def test_plan_executor_words_with_the_top_bit_set(cuda):
    """Every value's codec word has its top bit set (the float's low byte
    has bit 7 set), so an arithmetic shift in the decode would show: the
    card's coded words, on every XOR route, bitwise the NumPy executor."""
    from repro_torch.core.device_plan import DevicePlan
    from repro_torch.core.shuffle_plan import compile_plan_csr

    n = divisible_n(600, 4, 2)
    g = graphs.erdos_renyi(n, 0.02, seed=4)
    alloc = er_allocation(n, 4, 2)
    plan = compile_plan_csr(g.csr, alloc)
    tables = plan.edge_tables(g.csr, alloc)
    rng = np.random.default_rng(0)
    for B in (1, 3):
        shape = (g.csr.nnz, B) if B > 1 else (g.csr.nnz,)
        bits = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
        bits |= np.uint32(0x80)
        bits[(bits & 0x7F800000) == 0x7F800000] ^= np.uint32(0x40000000)
        ev = bits.view(np.float32)
        want = plan.execute_coded_sparse(ev, tables).values
        dp = DevicePlan(plan, cuda, tables=tables)
        for backend in ("numpy", "xor-kernel", "xor-ref"):
            got = dp.execute_sparse(torch.from_numpy(ev).to(cuda), "coded",
                                    backend=backend).values.cpu().numpy()
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


def test_xor_kernel_route_keeps_k1_dense_form(cuda):
    """backend="xor-kernel" keeps the column route of the reference's
    Pallas kernel: per Shuffle, K1's dense form once for the coded columns
    and once per slot for the strips, and neither plan kernel."""
    from repro_torch.core.device_plan import DevicePlan
    from repro_torch.core.shuffle_plan import compile_plan_csr

    n = divisible_n(400, 4, 2)
    g = graphs.erdos_renyi(n, 0.03, seed=3)
    alloc = er_allocation(n, 4, 2)
    plan = compile_plan_csr(g.csr, alloc)
    tables = plan.edge_tables(g.csr, alloc)
    dp = DevicePlan(plan, cuda, tables=tables)
    ev = np.random.default_rng(1).standard_normal(g.csr.nnz).astype(np.float32)
    want = plan.execute_coded_sparse(ev, tables).values.view(np.uint32)
    evt = torch.from_numpy(ev).to(cuda)
    _build.LAUNCHES.clear()
    for _ in range(10):
        got = dp.execute_sparse(evt, "coded", backend="xor-kernel")
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.values.cpu().numpy().view(np.uint32),
                                  want)
    assert _build.LAUNCHES["xor_encode_dense"] == 10 * (1 + plan.r)
    assert _build.LAUNCHES["xor_encode_plan"] == 0
    assert _build.LAUNCHES["xor_decode_plan"] == 0


def _random_plan_tables(rng, r, B, C=700, M=590, n_src=3000):
    """Random tables of the plan kernels in the ranges they accept: entries
    with the zero sentinel n_src, codes over the whole book and past it
    (read as empty), segments' columns up to one past the coded buffer
    (read as zero); src words with the codec word's top bit set in half of
    them."""
    from repro_torch.core.fused_shuffle import code_book

    src = rng.integers(0, 2 ** 32, size=(n_src, B) if B > 1 else (n_src,),
                       dtype=np.uint32)
    src[::2] |= np.uint32(0x80)

    def codes(shape):
        code = rng.integers(0, r + 2, size=shape).astype(np.uint8)
        code[rng.random(shape) < 0.02] = 255
        return code

    entries = lambda shape: rng.integers(0, n_src + 1, size=shape).astype(np.int32)  # noqa: E731
    t = dict(src=src.view(np.int32), slot_e=entries((C, r)),
             slot_code=codes((C, r)), book=code_book(r).view(np.int32),
             dec_pos=rng.integers(0, C + 1, size=(M, r)).astype(np.int32),
             dec_code=codes((M, r)), strip_e=entries((M, r, r - 1)),
             strip_code=codes((M, r, r - 1)))
    return t, _u32_coded(rng, C, B)


def _u32_coded(rng, C, B):
    """Random coded columns [C(, B)] as int32 words."""
    return rng.integers(0, 2 ** 32, size=(C, B) if B > 1 else (C,),
                        dtype=np.uint32).view(np.int32)


ENC_PLAN = ("src", "slot_e", "slot_code", "book")
DEC_PLAN = ("dec_pos", "dec_code", "strip_e", "strip_code", "book")


def _hold_plan_kernels(t, coded):
    """Both plan kernels bitwise their plain versions on tables `t` (device
    tensors): the encode, the decode of the kernel's coded columns and of
    `coded`. Returns the kernel's coded columns and delivered words."""
    enc = tuple(t[k] for k in ENC_PLAN)
    got = xc.xor_encode_plan(*enc)
    assert torch.equal(got, xref.xor_encode_plan(*enc))
    dec = tuple(t[k] for k in DEC_PLAN)
    for c in (got, coded):
        words = xc.xor_decode_plan(t["src"], c, *dec)
        assert torch.equal(words, xref.xor_decode_plan(t["src"], c, *dec))
    return got, xc.xor_decode_plan(t["src"], got, *dec)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 33, 64])
def test_plan_kernels_match_plain_on_random_tables(cuda, r, B):
    rng = np.random.default_rng(100 * r + B)
    t, coded = _random_plan_tables(rng, r, B)
    up = {k: torch.from_numpy(v).to(cuda) for k, v in t.items()}
    _hold_plan_kernels(up, torch.from_numpy(coded).to(cuda))
    # An empty schedule: nothing to launch for C = 0 and M = 0.
    none = {k: v if k in ("src", "book") else v[:0] for k, v in up.items()}
    _build.LAUNCHES.clear()
    coded0, words0 = _hold_plan_kernels(none, torch.zeros(
        (0, B) if B > 1 else (0,), dtype=torch.int32, device=cuda))
    assert coded0.shape[0] == 0 and words0.shape[0] == 0
    assert _build.LAUNCHES["xor_encode_plan"] == 0
    assert _build.LAUNCHES["xor_decode_plan"] == 0


@pytest.mark.parametrize("K,r", [(4, 1), (4, 2), (5, 3), (6, 4), (6, 5),
                                 (34, 33), (64, 64)])
def test_plan_kernels_on_session_tables(cuda, K, r):
    """The plan kernels on a plan's composed tables, every codec word's top
    bit set: bitwise their plain versions, and the delivered words bitwise
    the NumPy executor, at B = 1 and 4."""
    from repro_torch.core.device_plan import DevicePlan
    from repro_torch.core.shuffle_plan import compile_plan_csr

    n = divisible_n(256, K, r)
    g = graphs.erdos_renyi(n, 0.1, seed=r)
    alloc = er_allocation(n, K, r)
    plan = compile_plan_csr(g.csr, alloc)
    tables = plan.edge_tables(g.csr, alloc)
    dp = DevicePlan(plan, cuda, tables=tables)
    rng = np.random.default_rng(r)
    for B in (1, 4):
        shape = (g.csr.nnz, B) if B > 1 else (g.csr.nnz,)
        bits = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
        bits |= np.uint32(0x80)
        bits[(bits & 0x7F800000) == 0x7F800000] ^= np.uint32(0x40000000)
        src, ct = dp.coded_source(torch.from_numpy(bits.view(np.float32)).to(cuda))
        t = dict(ct._asdict(), src=src, book=dp.book)
        _, words = _hold_plan_kernels(t, torch.from_numpy(_u32_coded(
            rng, ct.slot_e.shape[0], B)).to(cuda))
        want = plan.execute_coded_sparse(bits.view(np.float32), tables).values
        np.testing.assert_array_equal(words.cpu().numpy().view(np.uint32),
                                      want.view(np.uint32).byteswap())


@pytest.mark.parametrize("failed", [(1,), (0, 1)])
def test_plan_kernels_on_a_repaired_plan(cuda, failed):
    """`fail` on backend="numpy", mode coded: the repaired plan's tables
    (dead receivers with no deliveries, dead senders with no columns; at
    |failed| = r re-Mapped vertices and pairs demoted to full-word leftover
    columns) through the plan kernels, bitwise their plain versions at
    B = 1 and 4, the delivered words bitwise the NumPy executor's, the
    state bitwise the healthy session's (sssp), one launch each per
    iteration, the bits the plan's plus the hand-over."""
    n = divisible_n(4000, 5, 2)
    g = graphs.erdos_renyi(n, 8.0 / n, seed=5)
    eng = engine.compile(algo.sssp(0), g, er_allocation(n, 5, 2), "coded",
                         path="sparse", device=cuda)
    healthy = eng.run(10)
    deg = eng.fail(failed)
    assert deg.recovery.handover_bits > 0
    assert (deg.recovery.demoted_pairs > 0) == (len(failed) == 2)
    assert (np.diff(deg.plan.ptr)[list(failed)] == 0).all()
    dp = deg.dplan
    for B in (1, 4):
        state = torch.rand((g.n, B) if B > 1 else (g.n,), device=cuda)
        ev = algo.pagerank().map_edge_values_t(deg._dg, state).contiguous()
        src, ct = dp.coded_source(ev)
        t = dict(ct._asdict(), src=src, book=dp.book)
        rng = np.random.default_rng(B)
        _, words = _hold_plan_kernels(t, torch.from_numpy(_u32_coded(
            rng, ct.slot_e.shape[0], B)).to(cuda))
        want = deg.plan.execute_coded_sparse(ev.cpu().numpy(),
                                             deg.tables).values
        np.testing.assert_array_equal(words.cpu().numpy().view(np.uint32),
                                      want.view(np.uint32).byteswap())
    _build.LAUNCHES.clear()
    res = deg.run(10)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["xor_encode_plan"] == 10
    assert _build.LAUNCHES["xor_decode_plan"] == 10
    assert torch.equal(res.state, healthy.state)
    assert res.shuffle_bits == 10 * (deg.plan.coded_bits
                                     + deg.plan.leftover_bits
                                     + deg.recovery.handover_bits)


def test_packed_kernels_on_rebound_tables(cuda):
    """`update` on backend="fused": the rebound exchange's packed tables
    through K1 / K2 bitwise their plain versions (B = 1 and 4), the state
    bitwise a fresh session's on the mutated graph (sssp), one launch each
    per iteration; then a server's columns and a receiver's deliveries
    taken out of those tables (a sender with no columns, a receiver with
    none): K1 / K2 still bitwise their plain versions."""
    from repro_torch.graphs import EdgeDelta

    g, eng = _session(cuda)
    rng = np.random.default_rng(3)
    csr = g.csr
    dels = sorted({(min(int(csr.rows[e]), int(csr.indices[e])),
                    max(int(csr.rows[e]), int(csr.indices[e])))
                   for e in rng.choice(csr.nnz, size=50, replace=False)})
    have = set(zip(csr.rows.tolist(), csr.indices.tolist()))
    ins = set()
    while len(ins) < 50:
        u, v = (int(x) for x in rng.integers(g.n, size=2))
        if u != v and (u, v) not in have:
            ins.add((min(u, v), max(u, v)))
    eng2 = eng.with_program(algo.sssp(0)).update(
        EdgeDelta.for_graph(g, insert=sorted(ins), delete=dels))
    assert eng2.fused is not eng.fused
    for B in (1, 4):
        _hold_packed(cuda, eng2.g, eng2, B)
    _build.LAUNCHES.clear()
    res = eng2.run(10)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["xor_encode"] == _build.LAUNCHES["xor_decode"] == 10
    fresh = engine.compile(algo.sssp(0), eng2.g, eng2.alloc, "coded",
                           path="sparse", backend="fused", device=cuda)
    assert torch.equal(res.state, fresh.run(10).state)
    t, fx = dict(eng2.fused.tables), eng2.fused
    t["enc_e"], t["enc_code"] = t["enc_e"].clone(), t["enc_code"].clone()
    t["enc_e"][1] = fx.nnz                        # sender 1: no columns
    t["enc_code"][1] = fx.sched.r + 1
    ptr = fx.plan.ptr.copy()
    counts = np.diff(ptr)
    counts[2] = 0                                 # receiver 2: no deliveries
    t["ptr"] = _i32(np.concatenate([[0], np.cumsum(counts)]), cuda)
    ev = algo.pagerank().map_edge_values_t(
        eng2._dg, torch.rand(eng2.g.n, device=cuda)).contiguous()
    src = ev.view(torch.int32)
    enc = (src, t["enc_e"], t["enc_code"], t["book"])
    buf = xc.xor_encode_packed(*enc)
    assert torch.equal(buf, xref.xor_encode_packed(*enc))
    assert not buf[1].any()
    dec = (src, buf, t["dec_pos"], t["dec_code"], t["strip_e"],
           t["strip_code"], t["book"], t["ptr"])
    words = xc.xor_decode_packed(*dec, total=int(counts.sum()))
    assert torch.equal(words, xref.xor_decode_packed(*dec))


def test_plan_kernels_on_leftovers_only(cuda):
    """A plan whose every delivery is a unicast leftover (C = 0, P = 0):
    the encode writes each leftover's own column, the decode reads them
    back, bitwise the NumPy executor, one launch each."""
    from repro_torch.core.allocation import bipartite_allocation
    from repro_torch.core.device_plan import DevicePlan
    from repro_torch.core.shuffle_plan import compile_plan_csr

    g = graphs.stochastic_block(48, 24, 0.25, 0.1, seed=5)
    alloc = bipartite_allocation(48, 24, 4, 4)
    plan = compile_plan_csr(g.csr, alloc)
    assert plan.slot_pair.shape[0] == 0 and plan.left_k.size > 0
    tables = plan.edge_tables(g.csr, alloc)
    dp = DevicePlan(plan, cuda, tables=tables)
    ev = np.random.default_rng(2).standard_normal(g.csr.nnz).astype(np.float32)
    _build.LAUNCHES.clear()
    got = dp.execute_sparse(torch.from_numpy(ev).to(cuda), "coded")
    np.testing.assert_array_equal(
        got.values.cpu().numpy().view(np.uint32),
        plan.execute_coded_sparse(ev, tables).values.view(np.uint32))
    assert _build.LAUNCHES["xor_encode_plan"] == 1
    assert _build.LAUNCHES["xor_decode_plan"] == 1


def test_plan_kernels_refuse_bad_inputs(cuda):
    """What the plan wrappers refuse on the card, before any launch: a
    float source (TypeError), a table that does not start 16-byte
    aligned."""
    from repro_torch.core.fused_shuffle import code_book

    book = torch.from_numpy(code_book(2).view(np.int32)).to(cuda)
    e = torch.zeros((9, 2), dtype=torch.int32, device=cuda)
    c = torch.zeros((9, 2), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        xc.xor_encode_plan(torch.zeros(5, device=cuda), e[:8], c[:8], book)
    with pytest.raises(ValueError, match="16-byte aligned"):
        xc.xor_encode_plan(torch.zeros(5, dtype=torch.int32, device=cuda),
                           e[1:], c[1:], book)
    s = torch.zeros((9, 2, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        xc.xor_decode_plan(torch.zeros(5, dtype=torch.int32, device=cuda),
                           torch.zeros(3, dtype=torch.int32, device=cuda),
                           e[1:], c[1:], s[1:], s[1:].to(torch.uint8), book)


def test_plan_launch_errors_raise(cuda, monkeypatch):
    """A CUDA error code from a plan kernel's launch raises, and the launch
    is not counted."""
    from repro_torch.core.fused_shuffle import code_book

    class FailingLaunch:
        def xor_encode_packed(self, *args):
            return 1

        xor_decode_packed = xor_encode_packed

        def repro_cuda_error_string(self, code):
            return b"invalid argument"

    book = torch.from_numpy(code_book(2).view(np.int32)).to(cuda)
    src = torch.zeros(5, dtype=torch.int32, device=cuda)
    e = torch.zeros((8, 2), dtype=torch.int32, device=cuda)
    c = torch.zeros((8, 2), dtype=torch.uint8, device=cuda)
    s = torch.zeros((8, 2, 1), dtype=torch.int32, device=cuda)
    monkeypatch.setattr(xc, "_lib", FailingLaunch)
    _build.LAUNCHES.clear()
    with pytest.raises(RuntimeError, match="failed to launch"):
        xc.xor_encode_plan(src, e, c, book)
    with pytest.raises(RuntimeError, match="failed to launch"):
        xc.xor_decode_plan(src, torch.zeros(8, dtype=torch.int32, device=cuda),
                           e, c, s, s.to(torch.uint8), book)
    assert _build.LAUNCHES["xor_encode_plan"] == 0
    assert _build.LAUNCHES["xor_decode_plan"] == 0


def test_column_routes_at_c0_and_r64(cuda):
    """K1's dense form through the column routes: C = 0 returns without a
    launch; r = 64, with and without a payload axis, bitwise its plain
    version; r = 65 refused with the CPU's message."""
    from repro_torch.kernels.xor_code import ops as xops

    _build.LAUNCHES.clear()
    empty = xops.xor_encode_columns(torch.zeros((0, 3), dtype=torch.int32,
                                                device=cuda))
    assert empty.shape == (0,) and _build.LAUNCHES["xor_encode_dense"] == 0
    rng = np.random.default_rng(64)
    for shape in ((1000, 64), (300, 64, 3)):
        w = torch.from_numpy(rng.integers(0, 2 ** 32, size=shape,
                                          dtype=np.uint32).view(np.int32))
        for fn in (xops.xor_encode_columns, xops.xor_strip_columns):
            got = fn(w.to(cuda))
            assert torch.equal(got.cpu(), fn(w))
            assert torch.equal(got.cpu(), fn(w.to(cuda), use_kernel=False).cpu())
    assert _build.LAUNCHES["xor_encode_dense"] == 2 * 65
    msg = r"^r = 65 slots: the column routes take 1 <= r <= 64$"
    for dev in (cuda, "cpu"):
        with pytest.raises(ValueError, match=msg):
            xops.xor_encode_columns(torch.zeros((4, 65), dtype=torch.int32,
                                                device=dev))


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


def _stream_case(rng, n, B, dev):
    """A CSR of `n` rows with 30% empty rows, degrees 0..40 (ragged tiles)
    and one row of 5,000 entries (a long tile of three parts), gather and
    values for K3 (standard normal, so sums cancel: only a sequential order
    is bitwise) and values for K5."""
    deg = rng.integers(0, 41, size=n)
    deg[rng.random(n) < 0.3] = 0
    deg[n // 3] = 5000
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nnz, M = int(indptr[-1]), 3000
    gather = rng.permutation(nnz + M)[:nnz].astype(np.int32)
    shape = lambda m: (m, B) if B > 1 else (m,)  # noqa: E731
    ev = rng.standard_normal(shape(nnz)).astype(np.float32)
    dv = rng.standard_normal(shape(M)).astype(np.float32)
    words = dv.view(np.uint32).byteswap().view(np.int32)
    indices = rng.integers(0, n, size=nnz).astype(np.int32)
    c = rng.standard_normal(shape(n)).astype(np.float32)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return up(indptr), up(gather), up(ev), up(words), up(indices), up(c)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("B", [1, 2, 4, 5])
def test_csr_stream_kernels_are_bitwise_the_sequential_version(cuda, B):
    """K3 (sum and min) and K5 on the CSR-streaming body: bitwise the
    sequential plain version, K3-min also bitwise the scatter plain
    version, two runs bitwise equal, K5 the same bits for every `bm`, with
    the table built by the wrappers or passed in."""
    indptr, gather, ev, words, indices, c = _stream_case(
        np.random.default_rng(B), 7001, B, cuda)
    assert int((indptr[1:] - indptr[:-1]).max()) > csr_tiles.TILE_ENTRIES
    tiles = torch.from_numpy(csr_tiles.tile_rows(indptr.cpu().numpy())).to(cuda)
    red = (ev, words, gather, indptr)
    for op, ident in (("sum", 0.0), ("min", float("inf"))):
        want = sr_ref.segment_reduce_seq(*red, op, ident)
        for t in (None, tiles):
            got = sr.segment_reduce(*red, op, ident, tiles=t)
            assert torch.equal(_bits(got), _bits(want)), (op, t is None)
        if op == "min":
            assert torch.equal(_bits(got), _bits(sr_ref.segment_reduce(*red, op, ident)))
        assert torch.equal(_bits(sr.segment_reduce(*red, op, ident, tiles=tiles)),
                           _bits(got))
    want = spmv_ref.spmv_csr_seq(indptr, indices, c)
    for bm in (1, 8, 128, 256):
        got = spmv_k.spmv_csr(indptr, indices, c, bm=bm, tiles=tiles)
        assert torch.equal(_bits(got), _bits(want)), bm
    assert torch.equal(_bits(spmv_k.spmv_csr(indptr, indices, c)), _bits(want))
    got = spmv_ops.spmv_csr_rows(indptr, indices, c, indptr.numel() - 1)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("backend", ["fused", "spmv"])
def test_power_law_session_matches_oracle(cuda, backend):
    """A Chung-Lu power-law graph (gamma 2.1, n about 20,000) with rows of
    up to ~6,000 entries (long tiles) and empty rows, on either route:
    pagerank within rtol 1e-5, sssp (fused) and degree (spmv) bitwise."""
    n = divisible_n(20_000, 4, 2)
    g = graphs.power_law(n, 2.1, seed=3)
    assert int(np.diff(g.csr.indptr).max()) > csr_tiles.TILE_ENTRIES
    eng = engine.compile(algo.pagerank(), g, er_allocation(n, 4, 2),
                         backend=backend, device=cuda)
    kernel = "segment_reduce" if backend == "fused" else "spmv_csr"
    _build.LAUNCHES.clear()
    res = eng.run(10)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == 10
    np.testing.assert_allclose(res.state.cpu().numpy(),
                               algo.reference_run(algo.pagerank(), g, 10),
                               rtol=1e-5, atol=0)
    other = algo.sssp(0) if backend == "fused" else algo.degree_count()
    got = eng.with_program(other).run(10 if backend == "fused" else 1)
    want = algo.reference_run(other, g, 10 if backend == "fused" else 1)
    np.testing.assert_array_equal(got.state.cpu().numpy().view(np.uint32),
                                  want.view(np.uint32))


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


def _chunk_inputs(rng, G, Ch, Q, P, N, dev, dtype=torch.float32, heads=1):
    """x, b and c in `dtype`, b and c of G // heads rows; dt, dta float32."""
    dt = rng.uniform(0.01, 0.2, (G, Ch, Q))
    arrays = (rng.standard_normal((G, Ch, Q, P)), dt,
              dt * -rng.uniform(0.5, 2.0, (G, 1, 1)),
              rng.standard_normal((G // heads, Ch, Q, N)),
              rng.standard_normal((G // heads, Ch, Q, N)))
    return [torch.from_numpy(a).to(dev, torch.float32 if i in (1, 2) else dtype)
            for i, a in enumerate(arrays)]


def _hold_chunk(args):
    got = ssd_k.ssd_chunk(*args)
    want = ssd_ref.ssd_chunk(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.parametrize("G,Ch,Q,P,N", [
    (1, 4, 16, 8, 4), (2, 4, 32, 16, 8), (3, 2, 64, 32, 16), (2, 2, 128, 8, 8),
    (1, 1, 32, 64, 32), (1, 3, 8, 4, 128), (2, 1, 128, 64, 64),
    (8, 32, 64, 64, 128)])
def test_ssd_chunk_matches_plain_version(cuda, G, Ch, Q, P, N):
    args = _chunk_inputs(np.random.default_rng(Q + P + N), G, Ch, Q, P, N, cuda)
    _hold_chunk(args)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G,Ch,Q,P,N,heads", [
    (128, 32, 64, 64, 128, 32),                      # the serve shape
    (4, 4, 16, 8, 4, 2), (4, 2, 128, 64, 128, 4),   # ragged Q = 16; Q = 128
    (2, 3, 5, 3, 7, 1), (2, 2, 200, 24, 40, 2), (2, 2, 128, 72, 136, 2),
    (2, 2, 1, 1, 1, 2)])
def test_ssd_chunk_bf16_and_shared_bc_match_plain_version(cuda, G, Ch, Q, P,
                                                          N, heads, dtype):
    """The serve path's inputs (bf16 x, b and c; b / c shared by `heads`
    groups) and ragged shapes, at the same rtol 1e-4 / atol 1e-4 max."""
    args = _chunk_inputs(np.random.default_rng(G + Q + N), G, Ch, Q, P, N,
                         cuda, dtype, heads)
    _hold_chunk(args)


@pytest.mark.parametrize("Ch", [1, 32, 256])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_state_scan_is_bitwise_its_plain_version(cuda, Ch, with_h0):
    """One multiply and one add per chunk, each rounded, in the same order
    as the plain version's two tensor ops: the same bits."""
    rng = np.random.default_rng(Ch)
    G = torch.from_numpy(np.exp(-rng.uniform(0.0, 3.0, (6, Ch)))).to(cuda, torch.float32)
    S = torch.from_numpy(rng.standard_normal((6, Ch, 16, 8))).to(cuda, torch.float32)
    h0 = (torch.from_numpy(rng.standard_normal((6, 16, 8))).to(cuda, torch.float32)
          if with_h0 else None)
    h_in, h_fin = ssd_k.ssd_state_scan(G, S, h0)
    w_in, w_fin = ssd_ref.ssd_state_scan(G, S, h0)
    assert torch.equal(h_in, w_in) and torch.equal(h_fin, w_fin)


@pytest.mark.parametrize("G,L,P,N,chunk", [
    (1, 64, 8, 4, 16), (2, 128, 16, 8, 32), (3, 128, 32, 16, 64),
    (2, 256, 8, 8, 128), (1, 32, 64, 32, 32)])
def test_ssd_matches_sequential_oracle_on_the_card(cuda, G, L, P, N, chunk):
    rng = np.random.default_rng(L + N)
    arrays = (rng.standard_normal((G, L, P)), rng.uniform(0.01, 0.2, (G, L)),
              -rng.uniform(0.5, 2.0, G), rng.standard_normal((G, L, N)),
              rng.standard_normal((G, L, N)), rng.standard_normal(G))
    args = [torch.from_numpy(a).to(cuda, torch.float32) for a in arrays]
    _build.LAUNCHES.clear()
    y, h = ssd_ops.ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssd_chunk"] == 1 and _build.LAUNCHES["ssd_state_scan"] == 1
    y_ref, h_ref = ssd_ref.ssd_scan_batched(*args)
    torch.testing.assert_close(y, y_ref, rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(h, h_ref, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,P,N", [(128, 64, 128), (180, 64, 128),
                                   (256, 64, 128), (400, 64, 128),
                                   (256, 256, 256)])
def test_ssd_chunk_large_chunks_one_shot_and_in_parts(cuda, Q, P, N, dtype):
    """Chunks up to 400 tokens at K6's gates, one launch each: one shot
    where a chunk fits a block (bf16 up to Q = 356 at Mamba2's P = 64,
    N = 128), else staged in parts (float32 from Q = 180, with a ragged
    last part of 4 tokens there; bf16 at Q = 400 and at P = N = 256)."""
    args = _chunk_inputs(np.random.default_rng(Q + P), 4, 2, Q, P, N, cuda,
                         dtype, 2)
    _build.LAUNCHES.clear()
    got = ssd_k.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssd_chunk"] == 1
    for g, w in zip(got, ssd_ref.ssd_chunk(*args)):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


def test_ssd_chunk_past_one_block_and_past_the_limit(cuda):
    """A 256 x 256 x 256 chunk, once refused, runs staged in parts; a shape
    where not even 16 tokens fit a block is refused."""
    for dtype in (torch.float32, torch.bfloat16):
        args = _chunk_inputs(np.random.default_rng(0), 1, 1, 256, 256, 256,
                             cuda, dtype)
        assert ssd_k.part_tokens(256, 256, 256, dtype) < 256
        _hold_chunk(args)
        wide = _chunk_inputs(np.random.default_rng(0), 1, 1, 16, 4096, 4096,
                             cuda, dtype)
        with pytest.raises(ValueError, match="shared memory"):
            ssd_k.ssd_chunk(*wide)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_at_chunk_256_on_the_card(cuda, dtype):
    rng = np.random.default_rng(256)
    G, L, P, N = 2, 512, 64, 128
    x, B, C = (torch.from_numpy(rng.standard_normal(s)).to(cuda, dtype)
               for s in ((G, L, P), (G, L, N), (G, L, N)))
    dt, A, D = (torch.from_numpy(a).to(cuda, torch.float32) for a in (
        rng.uniform(0.01, 0.2, (G, L)), -rng.uniform(0.5, 2.0, G),
        rng.standard_normal(G)))
    y, hT = ssd_ops.ssd(x, dt, A, B, C, D, chunk=256)
    y_ref, h_ref = ssd_ref.ssd_scan_batched(x, dt, A, B, C, D)
    torch.testing.assert_close(y, y_ref, rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(hT, h_ref, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_with_shared_bc_on_the_card(cuda, dtype):
    """`ops.ssd` on the serve path's layout: x, B and C in `dtype`, B / C
    shared by 4 groups, one launch of K6 and of K7, against the sequential
    oracle on the same values materialised per group at 5e-4."""
    rng = np.random.default_rng(3)
    G, L, P, N, h = 8, 256, 16, 32, 4
    x, B, C = (torch.from_numpy(rng.standard_normal(s)).to(cuda, dtype)
               for s in ((G, L, P), (G // h, L, N), (G // h, L, N)))
    dt, A, D = (torch.from_numpy(a).to(cuda, torch.float32) for a in (
        rng.uniform(0.01, 0.2, (G, L)), -rng.uniform(0.5, 2.0, G),
        rng.standard_normal(G)))
    _build.LAUNCHES.clear()
    y, hT = ssd_ops.ssd(x, dt, A, B, C, D, chunk=64)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssd_chunk"] == 1 and _build.LAUNCHES["ssd_state_scan"] == 1
    y_ref, h_ref = ssd_ref.ssd_scan_batched(
        x, dt, A, B.repeat_interleave(h, 0), C.repeat_interleave(h, 0), D)
    torch.testing.assert_close(y, y_ref, rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(hT, h_ref, rtol=5e-4, atol=5e-4)


def test_mamba2_served_on_the_card(cuda):
    cfg = configs.get("mamba2-370m").reduced()
    params = init_params(tfm.model_spec(cfg),
                         torch.Generator(device=cuda).manual_seed(0),
                         dtype=torch.float32, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 32))).to(cuda)
    _build.LAUNCHES.clear()
    got = dec.prefill(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssd_chunk"] == cfg.n_layers
    assert _build.LAUNCHES["ssd_state_scan"] == cfg.n_layers
    plain = dec.prefill(params, cfg, {"tokens": toks}, use_kernel=False)
    scale = float(plain.abs().max())
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-4 * scale)
    cache = dec.init_cache(cfg, ShapeSpec("s", 32, 2, "decode"),
                           dtype=torch.float32, device=cuda)
    for i in range(32):
        step, cache = dec.decode_step(params, cfg, cache,
                                      {"tokens": toks[:, i:i + 1]})
    torch.testing.assert_close(step, plain, rtol=0, atol=1e-4 * scale)
    out = serve.generate(cfg, params, toks[:, :4].cpu().numpy(), 6, device=cuda)
    assert out.shape == (2, 6) and out.min() >= 0 and out.max() < cfg.vocab


def test_nccl_world_one_group_is_the_virtual_route(cuda, tmp_path):
    """The fused exchange on a one-rank NCCL group (FileStore, no port):
    words, states and bits bitwise the virtual route's, K1 / K2 launched."""
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "s"), 1),
                            rank=0, world_size=1)
    try:
        g, virt = _session(cuda)
        grp = engine.compile(algo.pagerank(), g, virt.alloc, plan=virt.plan,
                             path="sparse", backend="fused", device=cuda,
                             group=dist.group.WORLD)
        pr = algo.pagerank()
        ev = pr.map_edge_values_t(virt._dg, torch.as_tensor(
            pr.init(g), device=cuda)).contiguous()
        assert torch.equal(grp.fused.exchange(ev), virt.fused.exchange(ev))
        for p in (pr, algo.sssp(0)):
            _build.LAUNCHES.clear()
            a = grp.with_program(p).run(5)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["xor_encode"] == 5
            assert _build.LAUNCHES["xor_decode"] == 5
            b = virt.with_program(p).run(5)
            assert torch.equal(a.state.view(torch.int32), b.state.view(torch.int32))
            assert a.shuffle_bits == b.shuffle_bits
    finally:
        dist.destroy_process_group()


def _rank_exchanges(monkeypatch, g, eng, P, dev):
    """The group route's sessions of `eng`'s plan for the P ranks of a
    group, built in this one process: `server_shard` answers each rank's
    share, so each session uploads its servers' rows of the packed tables
    and its ptr rebased to them, as it would on a P-rank group."""
    from repro_torch.core import fused_shuffle as fs
    from repro_torch.launch.dist import ServerShard

    ranks = []
    for p in range(P):
        monkeypatch.setattr(fs, "server_shard", lambda group, K, device, p=p:
                            ServerShard(group, P, p, K))
        ranks.append(fs.FusedSparseShuffle(eng.plan, g.csr, eng.alloc,
                                           device=dev, group="one rank"))
    return ranks


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("K,r,P", [(4, 2, 2), (4, 2, 4), (8, 3, 2), (8, 3, 4)])
def test_packed_kernels_on_each_ranks_rows(cuda, monkeypatch, K, r, P, B):
    """The shapes the group route gives K1 and K2, without a process
    group: K1 on each rank's K / P server rows, the buffers concatenated
    in rank order (what the all-gather hands every rank), then K2 for each
    rank's receivers on the K senders' buffer. Each launch is bitwise its
    plain version, the buffer bitwise the whole session's K1 and the
    words, concatenated in rank order, bitwise the virtual route's."""
    g, eng = _session(cuda, n=2000, K=K, r=r)
    ev, words = _hold_packed(cuda, g, eng, B)
    src, t = ev.view(torch.int32), eng.fused.tables
    whole = xc.xor_encode_packed(src, t["enc_e"], t["enc_code"], t["book"])
    ranks = _rank_exchanges(monkeypatch, g, eng, P, cuda)
    bufs = []
    for rk in ranks:
        t = rk.tables
        assert t["enc_e"].shape[0] == K // P
        enc = (src, t["enc_e"], t["enc_code"], t["book"])
        bufs.append(xc.xor_encode_packed(*enc))
        assert torch.equal(bufs[-1], xref.xor_encode_packed(*enc))
    buf = torch.cat(bufs)
    assert torch.equal(buf, whole)
    got = []
    for rk in ranks:
        t = rk.tables
        dec = (src, buf, t["dec_pos"], t["dec_code"], t["strip_e"],
               t["strip_code"], t["book"], t["ptr"])
        got.append(xc.xor_decode_packed(*dec, total=rk.M_local))
        assert torch.equal(got[-1], xref.xor_decode_packed(*dec))
    assert torch.equal(torch.cat(got), words)
