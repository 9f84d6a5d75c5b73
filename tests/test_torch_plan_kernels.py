"""The plan executors' coded encode / decode on the plan's own tables
(`xor_encode_plan`, `xor_decode_plan`) against the reference package, on
the CPU.

On CPU tensors the wrappers run the plain versions in
`kernels/xor_code/ref.py`; the CUDA kernels are held against those on the
card (`tests/test_torch_cuda.py`, `chip_smoke.py`). Here:

* delivered words of `DevicePlan` (backend "numpy", the reference's
  default engine) bitwise `ShufflePlan.execute_coded_sparse` (sparse) and
  `execute_coded` (dense) of `repro.core.shuffle_plan`, and the coded
  columns bitwise the reference's XOR of its slot words, at r in 1..5 and
  33 (zero-width segments), B in 1 and 4, on random finite bit patterns
  with every codec word's top bit set; an empty schedule (r = K) and a
  plan with only unicast leftovers; one small case against the
  reference's Pallas route (backend="xor-kernel", interpret mode);
* the composed tables unpack to the plan's slot_pair / slot_shift /
  slot_mask, pair_col / pair_slot and leftovers, and a plan whose
  positions do not cover [0, M) once is refused before anything runs;
* the whole default engine (backend="numpy", mode coded, device="cpu")
  against the reference's engine: min and integer programs bitwise,
  pagerank and personalized pagerank within rtol 1e-5, bits exact;
* the wrappers' limits, refused on the CPU as on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import algorithms as r_algo
from repro.core import engine as r_engine
from repro.core import graph_models as r_gm
from repro.core.allocation import (bipartite_allocation, divisible_n,
                                   er_allocation)
from repro.core.bitcodec import floats_to_words
from repro.core.shuffle_plan import compile_plan as r_compile
from repro.core.shuffle_plan import compile_plan_csr as r_compile_csr
from repro_torch.core import algorithms as t_algo
from repro_torch.core import convert
from repro_torch.core import engine as t_engine
from repro_torch.core.bitcodec import t_words_to_np
from repro_torch.core.device_plan import DevicePlan
from repro_torch.kernels.xor_code import ops as xops

CPU = torch.device("cpu")
R_SERVERS = {1: 4, 2: 4, 3: 5, 4: 6, 5: 6, 33: 34}     # r -> K


def _port(g, alloc):
    fields = {f.name: getattr(alloc, f.name) for f in dataclasses.fields(alloc)}
    return (convert.graph(g.csr.indptr, g.csr.indices, g.csr.rows,
                          g.edge_weights()),
            convert.allocation(fields))


def _port_plan(plan):
    return convert.shuffle_plan({f.name: getattr(plan, f.name)
                                 for f in dataclasses.fields(plan)})


def _case(name):
    """(reference graph, allocation) by name: "r<r>" an ER graph with K
    servers for that r, "rK" r = K (nothing to move), "left" a bipartite
    allocation whose batches all have fewer than r servers (only unicast
    leftovers), "spill" covered pairs and leftovers."""
    if name.startswith("r") and name[1:].isdigit():
        r = int(name[1:])
        K = R_SERVERS[r]
        n = divisible_n(200, K, r)
        return r_gm.erdos_renyi(n, 0.1, seed=r), er_allocation(n, K, r)
    if name == "rK":
        n = divisible_n(24, 4, 4)
        return r_gm.erdos_renyi(n, 0.5, seed=0), er_allocation(n, 4, 4)
    if name == "left":
        return (r_gm.stochastic_block(48, 24, 0.25, 0.1, seed=5),
                bipartite_allocation(48, 24, 4, 4))
    if name == "spill":
        return (r_gm.stochastic_block(48, 24, 0.25, 0.1, seed=5),
                bipartite_allocation(48, 24, 6, 3))
    raise ValueError(name)


def _top_bit(rng, shape) -> np.ndarray:
    """float32 of random finite bit patterns whose codec word (the byteswap
    of the bits) has its top bit set, so an arithmetic shift would show."""
    bits = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    bits |= np.uint32(0x80)
    bits[(bits & 0x7F800000) == 0x7F800000] ^= np.uint32(0x40000000)
    return bits.view(np.float32)


def _sparse(name, B, seed=0):
    """Reference plan, its edge tables, the edge values, the port's
    DevicePlan on the CPU and its sparse tables."""
    g, alloc = _case(name)
    tg, ta = _port(g, alloc)
    plan = r_compile_csr(g.csr, alloc)
    tables = plan.edge_tables(g.csr, alloc)
    shape = (g.csr.nnz, B) if B > 1 else (g.csr.nnz,)
    ev = _top_bit(np.random.default_rng(seed), shape)
    tplan = _port_plan(plan)
    ttables = tplan.edge_tables(tg.csr, ta)
    return plan, tables, ev, DevicePlan(tplan, CPU, tables=ttables), ttables


def _dec(t, dp):
    """The decode's tables after the source and the coded columns."""
    return t.dec_pos, t.dec_code, t.strip_e, t.strip_code, dp.book


def _reference_coded(plan, pair_vals) -> np.ndarray:
    """The reference's coded columns: the XOR of its slot words."""
    return np.bitwise_xor.reduce(plan._slot_words(pair_vals), axis=1)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("r", sorted(R_SERVERS))
def test_sparse_words_match_execute_coded_sparse(r, B):
    plan, tables, ev, dp, _ = _sparse(f"r{r}", B)
    assert plan.pair_k.size > 0
    want = plan.execute_coded_sparse(ev, tables)
    got = dp.execute_sparse(torch.from_numpy(ev), "coded")
    np.testing.assert_array_equal(floats_to_words(got.values.numpy()),
                                  floats_to_words(want.values))
    assert got.bits_sent == want.bits_sent
    # The encode alone: the coded columns, then the leftovers' words.
    src, t = dp.coded_source(torch.from_numpy(ev))
    coded = xops.xor_encode_plan(src, t.slot_e, t.slot_code, dp.book)
    C = plan.slot_pair.shape[0]
    np.testing.assert_array_equal(t_words_to_np(coded[:C]),
                                  _reference_coded(plan, ev[tables.pair_e]))
    np.testing.assert_array_equal(t_words_to_np(coded[C:]),
                                  floats_to_words(ev[tables.left_e]))
    words = xops.xor_decode_plan(src, coded, *_dec(t, dp))
    np.testing.assert_array_equal(t_words_to_np(words),
                                  floats_to_words(want.values))


@pytest.mark.parametrize("r", sorted(R_SERVERS))
def test_dense_words_match_execute_coded(r):
    g, alloc = _case(f"r{r}")
    tg, ta = _port(g, alloc)
    rng = np.random.default_rng(r)
    vals = np.where(g.adj, _top_bit(rng, (g.n, g.n)), np.float32(0))
    plan = r_compile(g.adj, alloc)
    want = plan.execute_coded(vals)
    dp = DevicePlan(_port_plan(plan), CPU, dense=True)
    got = dp.execute(torch.from_numpy(vals), "coded")
    np.testing.assert_array_equal(floats_to_words(got.values.numpy()),
                                  floats_to_words(want.values))
    assert got.bits_sent == want.bits_sent
    src, t = dp.coded_source(torch.from_numpy(vals), dense=True)
    coded = xops.xor_encode_plan(src, t.slot_e, t.slot_code, dp.book)
    C = plan.slot_pair.shape[0]
    np.testing.assert_array_equal(
        t_words_to_np(coded[:C]), _reference_coded(plan, vals[plan.pair_i,
                                                              plan.pair_j]))
    np.testing.assert_array_equal(
        t_words_to_np(xops.xor_decode_plan(src, coded, *_dec(t, dp))),
        floats_to_words(want.values))


@pytest.mark.parametrize("layout", ["transposed", "broadcast"])
def test_dense_words_at_the_maps_layouts(layout):
    """The dense Maps hand over transposed (sssp) and broadcast (cc)
    [n, n] values: the tables index their storage at its strides, with no
    copy, bitwise `execute_coded` on the same values."""
    g, alloc = _case("r3")
    rng = np.random.default_rng(5)
    if layout == "transposed":
        vals = torch.from_numpy(np.ascontiguousarray(
            _top_bit(rng, (g.n, g.n)).T)).T
    else:
        vals = torch.from_numpy(_top_bit(rng, g.n))[None, :].expand(g.n, g.n)
    assert not vals.is_contiguous()
    plan = r_compile(g.adj, alloc)
    want = plan.execute_coded(vals.numpy())
    dp = DevicePlan(_port_plan(plan), CPU, dense=True)
    src, _ = dp.coded_source(vals, dense=True)
    assert src.data_ptr() == vals.data_ptr()            # no copy
    got = dp.execute(vals, "coded")
    np.testing.assert_array_equal(floats_to_words(got.values.numpy()),
                                  floats_to_words(want.values))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("name", ["rK", "left"])
def test_empty_schedule_and_leftovers_only(name, B):
    """r = K: C = 0 and M = 0; the bipartite allocation with r above both
    clusters' server counts: C = 0, P = 0, every delivery a leftover,
    each its own full-word column of the exchange."""
    plan, tables, ev, dp, _ = _sparse(name, B)
    assert plan.slot_pair.shape[0] == 0 and plan.pair_k.size == 0
    assert (dp.M == 0) == (name == "rK")
    want = plan.execute_coded_sparse(ev, tables)
    for backend in ("numpy", "xor-kernel", "xor-ref"):
        got = dp.execute_sparse(torch.from_numpy(ev), "coded",
                                backend=backend)
        assert got.values.shape == want.values.shape
        np.testing.assert_array_equal(floats_to_words(got.values.numpy()),
                                      floats_to_words(want.values))
        assert got.bits_sent == want.bits_sent
    src, t = dp.coded_source(torch.from_numpy(ev))
    coded = xops.xor_encode_plan(src, t.slot_e, t.slot_code, dp.book)
    L = tables.left_e.size
    assert coded.shape == ((L, B) if B > 1 else (L,))
    np.testing.assert_array_equal(t_words_to_np(coded),
                                  floats_to_words(ev[tables.left_e]))


def test_numpy_route_matches_the_reference_pallas_route():
    """One small case through the reference's backend="xor-kernel" (its
    Pallas kernel, in interpret mode on the CPU): the port's three routes,
    sparse and dense, bitwise."""
    plan, tables, ev, dp, _ = _sparse("r3", 1, seed=3)
    want = plan.execute_coded_sparse(ev, tables, backend="xor-kernel")
    for backend in ("numpy", "xor-kernel", "xor-ref"):
        got = dp.execute_sparse(torch.from_numpy(ev), "coded",
                                backend=backend)
        np.testing.assert_array_equal(floats_to_words(got.values.numpy()),
                                      floats_to_words(want.values))
    g, alloc = _case("r3")
    vals = np.where(g.adj, _top_bit(np.random.default_rng(4), (g.n, g.n)),
                    np.float32(0))
    rplan = r_compile(g.adj, alloc)
    dense = DevicePlan(_port_plan(rplan), CPU, dense=True)
    np.testing.assert_array_equal(
        floats_to_words(dense.execute(torch.from_numpy(vals), "coded")
                        .values.numpy()),
        floats_to_words(rplan.execute_coded(vals, backend="xor-kernel").values))


@pytest.mark.parametrize("name", ["r2", "r5", "r33", "spill", "left"])
def test_composed_tables_unpack_to_the_plan(name):
    plan, tables, ev, dp, ttables = _sparse(name, 1)
    g, alloc = _case(name)
    (C, r), P, L = plan.slot_pair.shape, plan.pair_k.size, tables.left_e.size
    book = dp.book.numpy().view(np.uint32)
    _, t = dp.coded_source(torch.from_numpy(ev))
    code, slot_e = t.slot_code.numpy(), t.slot_e.numpy()
    assert code.shape == slot_e.shape == (C + L, r)
    np.testing.assert_array_equal(book[0][code[:C]], plan.slot_shift)
    np.testing.assert_array_equal(book[1][code[:C]], plan.slot_mask)
    nnz = g.csr.nnz
    real = plan.slot_pair < P
    np.testing.assert_array_equal(slot_e[:C] == nnz, ~real)
    sp = plan.slot_pair[real]
    np.testing.assert_array_equal(g.csr.rows[slot_e[:C][real]], plan.pair_i[sp])
    np.testing.assert_array_equal(g.csr.indices[slot_e[:C][real]],
                                  plan.pair_j[sp])
    # A leftover: its entry, full word, in slot 0 of its own column.
    np.testing.assert_array_equal(slot_e[C:, 0], tables.left_e)
    assert (slot_e[C:, 1:] == nnz).all()
    assert (code[C:, 0] == r).all() and (code[C:, 1:] == r + 1).all()
    # Dense, row-major values: the flat index of the (i, j), sentinel n * n.
    dense = DevicePlan(_port_plan(plan), CPU, dense=True)
    flat = dense.coded_source(torch.zeros((g.n, g.n)), dense=True)[1]
    flat = flat.slot_e.numpy()
    np.testing.assert_array_equal(flat[:C] == g.n * g.n, ~real)
    np.testing.assert_array_equal(np.divmod(flat[:C][real], g.n),
                                  (plan.pair_i[sp], plan.pair_j[sp]))
    np.testing.assert_array_equal(np.divmod(flat[C:, 0], g.n),
                                  (plan.left_i, plan.left_j))
    # The deliveries in position order: a pair's segments at its columns
    # and slots, a leftover's at its own column; K2's tables from them.
    cs = t.dec_cs.numpy().astype(np.int64)
    np.testing.assert_array_equal(cs[plan.pos_covered],
                                  plan.pair_col * r + plan.pair_slot)
    np.testing.assert_array_equal(
        cs[plan.pos_left], (C + np.arange(L))[:, None] * r + np.arange(r))
    np.testing.assert_array_equal(t.dec_pos.numpy(), cs // r)
    np.testing.assert_array_equal(t.dec_code.numpy(), code.reshape(-1)[cs])
    others = np.sort(t.strip_e.numpy(), axis=-1)
    col_e = slot_e[cs // r]                                # [M, r, r]
    drop = np.arange(r)[None, None, :] != (cs % r)[..., None]
    np.testing.assert_array_equal(
        others, np.sort(col_e[drop].reshape(others.shape), axis=-1))
    np.testing.assert_array_equal(
        np.sort(t.strip_code.numpy(), axis=-1),
        np.sort(code[cs // r][drop].reshape(others.shape), axis=-1))


@pytest.mark.parametrize("fault", ["out of range", "negative", "repeated",
                                   "segment"])
def test_plan_with_bad_positions_is_refused(fault):
    """The coded route scatters the deliveries by their positions and
    gathers the segments' slots, so a plan whose positions do not cover
    [0, M) once, or whose segment names no slot, is refused (ValueError)
    at the first coded Shuffle (or where `coded=True` composes the tables
    at once), before anything is composed or run."""
    plan, tables, ev, dp, ttables = _sparse("spill", 1)
    tplan = dp.plan
    assert tplan.pos_covered.size and tplan.pos_left.size
    pos_left, pair_col = tplan.pos_left.copy(), tplan.pair_col.copy()
    if fault == "out of range":
        pos_left[0] = tplan.all_k.size
    elif fault == "negative":
        pos_left[0] = -1
    elif fault == "repeated":
        pos_left[0] = tplan.pos_covered[0]
    else:
        pair_col[0, 0] = tplan.slot_pair.shape[0]
    bad = DevicePlan(dataclasses.replace(tplan, pos_left=pos_left,
                                         pair_col=pair_col), CPU,
                     tables=ttables)
    for backend in ("numpy", "xor-kernel", "xor-ref"):
        with pytest.raises(ValueError, match="cover|out of range"):
            bad.execute_sparse(torch.from_numpy(ev), "coded", backend=backend)
    assert not bad._coded
    with pytest.raises(ValueError, match="cover|out of range"):
        DevicePlan(bad.plan, CPU, tables=ttables, coded=True)


ENGINE_PROGS = ("pagerank", "sssp", "cc", "degree", "multi_sssp", "ppr")


def _engine_programs(name, n):
    if name == "pagerank":
        return r_algo.pagerank(), t_algo.pagerank()
    if name == "sssp":
        return r_algo.sssp(0), t_algo.sssp(0)
    if name == "cc":
        return r_algo.connected_components(), t_algo.connected_components()
    if name == "degree":
        return r_algo.degree_count(), t_algo.degree_count()
    if name == "multi_sssp":
        roots = [0, n // 5, n // 2, n - 1]
        return r_algo.multi_sssp(roots), t_algo.multi_sssp(roots)
    prefs = np.random.default_rng(n).random((n, 4)).astype(np.float32)
    prefs /= prefs.sum(axis=0)
    return (r_algo.personalized_pagerank(prefs),
            t_algo.personalized_pagerank(prefs))


@pytest.mark.parametrize("prog", ENGINE_PROGS)
@pytest.mark.parametrize("name", ["r3", "r5", "spill"])
def test_default_engine_coded_matches_reference(name, prog):
    g, alloc = _case(name)
    tg, ta = _port(g, alloc)
    rprog, tprog = _engine_programs(prog, g.n)
    want = r_engine.run(rprog, g, alloc, 3, mode="coded")
    got = t_engine.run(tprog, tg, ta, 3, mode="coded", path="auto",
                       backend="numpy", device="cpu")
    state = got.state.numpy()
    assert state.shape == want.state.shape
    if prog in ("pagerank", "ppr"):
        np.testing.assert_allclose(state, want.state, rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(state.view(np.uint32),
                                      want.state.view(np.uint32))
    assert got.shuffle_bits == want.shuffle_bits


def test_plan_wrappers_refuse_what_the_card_refuses():
    src = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"1 <= r <= 64"):
        xops.xor_encode_plan(src, torch.zeros((3, 65), dtype=torch.int32),
                             torch.zeros((3, 65), dtype=torch.uint8),
                             torch.zeros((2, 67), dtype=torch.int32))
    with pytest.raises(ValueError, match="slot_code must be"):
        xops.xor_encode_plan(src, torch.zeros((3, 2), dtype=torch.int32),
                             torch.zeros((3, 3), dtype=torch.uint8),
                             torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="dec_pos must be"):
        xops.xor_decode_plan(src, torch.zeros(3, dtype=torch.int32),
                             torch.zeros(3, dtype=torch.int32),
                             torch.zeros(3, dtype=torch.uint8),
                             torch.zeros((3, 1, 0), dtype=torch.int32),
                             torch.zeros((3, 1, 0), dtype=torch.uint8),
                             torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"1 <= r <= 64"):
        xops.xor_decode_plan(src, torch.zeros(3, dtype=torch.int32),
                             torch.zeros((2, 65), dtype=torch.int32),
                             torch.zeros((2, 65), dtype=torch.uint8),
                             torch.zeros((2, 65, 64), dtype=torch.int32),
                             torch.zeros((2, 65, 64), dtype=torch.uint8),
                             torch.zeros((2, 67), dtype=torch.int32))
