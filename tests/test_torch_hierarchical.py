"""The port's two-level (racks x servers) coded Shuffle and the engine's
defaults vs the reference package, on the CPU.

* The engine's defaults are the reference's (path="auto", backend="numpy"):
  `engine.run(prog, g, alloc, 3, mode=m, device="cpu")` with nothing else
  named gives the reference's states (sssp bitwise, pagerank within rtol
  1e-5) and exact bits in every distributed mode, with `alloc=None`, and
  for a program without a sparse form (the dense path).
* On the cases of `tests/test_hierarchical_fused.py` (er / pl / sbm at
  K = 8, r = 2 on `Topology(4, 2)` and `(2, 4)`; the bipartite spill
  `bipartite_allocation(32, 18, 6, 3)` on `(3, 2)` and `(2, 3)`; a batched
  multi_sssp at B = 3):
  - `compile_hierarchical` bitwise the reference's, every array of both
    levels, `rack_alloc`, the routing tables and the per-level bits;
    `Topology.flat(K)` degenerates to `compile_plan_csr` array for array,
    `Topology(1, K)` is all intra-rack;
  - `partition_hierarchical` bitwise the reference's, and
    `pack_hierarchical` unpacks back to it;
  - the fused exchange (K1 / K2 with direct words, their plain versions
    here) and the numpy route (`HierarchicalDevicePlan`) deliver words
    bitwise the reference's `HierarchicalPlan.execute_coded_sparse` and
    the flat `execute_coded_sparse`, with the reference's bits;
  - `engine.run(..., topology=)` on both backends against the reference's:
    states, `shuffle_bits`, `loads()`; the validation errors in the
    reference's order, with its messages.
* `loads.empirical_loads` (with and without a topology) and the paper's
  closed forms against the reference's, on the cases of
  `tests/test_loads.py` and `tests/test_theorem1.py`.
* `launch/roofline` against the reference's arithmetic, given the same
  constants; an unknown card raises.
* K2's plain version with `direct_e` against the composition it replaces.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro import graphs as r_graphs
from repro.core import algorithms as r_algo
from repro.core import engine as r_engine
from repro.core import fused_shuffle as r_fused
from repro.core import loads as r_loads
from repro.core.allocation import (bipartite_allocation, divisible_n,
                                   er_allocation)
from repro.core.bitcodec import floats_to_words
from repro.core.shuffle_plan import compile_hierarchical as r_compile_h
from repro.core.shuffle_plan import compile_plan_csr as r_compile
from repro.launch import mesh as r_mesh
from repro.launch import roofline as r_roof
from repro_torch.core import algorithms as t_algo
from repro_torch.core import convert
from repro_torch.core import engine as t_engine
from repro_torch.core import fused_shuffle as t_fused
from repro_torch.core import loads as t_loads
from repro_torch.core.bitcodec import t_words_to_np
from repro_torch.core.device_plan import HierarchicalDevicePlan
from repro_torch.core.shuffle_plan import compile_hierarchical as t_compile_h
from repro_torch.core.shuffle_plan import compile_plan_csr as t_compile
from repro_torch.kernels.xor_code import ref as xref
from repro_torch.kernels.xor_code import xor_code as xc
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import roofline as t_roof

SUM_TOL = dict(rtol=1e-5, atol=0)
SHAPES = {"er": ((4, 2), (2, 4)), "pl": ((4, 2), (2, 4)),
          "sbm": ((4, 2), (2, 4)), "spill": ((3, 2), (2, 3))}
CASES = [(m, s) for m, shapes in SHAPES.items() for s in shapes]
IDS = [f"{m}-{r}x{s}" for m, (r, s) in CASES]


def _case(model):
    """The cases of tests/test_hierarchical_fused.py."""
    K, r = 8, 2
    if model == "er":
        n = divisible_n(96, K, r)
        return (r_graphs.erdos_renyi(n, 0.15, seed=11),
                er_allocation(n, K, r, interleave=True))
    if model == "pl":
        n = divisible_n(96, K, r)
        return (r_graphs.power_law(n, 2.5, seed=9),
                er_allocation(n, K, r, interleave=True))
    if model == "sbm":
        n = divisible_n(112, K, r)
        return (r_graphs.stochastic_block(n // 2, n // 2, 0.25, 0.05, seed=5),
                er_allocation(n, K, r, interleave=True))
    if model == "spill":                   # r > K2: unicast leftovers
        return (r_graphs.random_bipartite(32, 18, 0.3, seed=5),
                bipartite_allocation(32, 18, 6, 3))
    if model == "er4":                     # the engine defaults' case
        n = divisible_n(96, 4, 2)
        return r_graphs.erdos_renyi(n, 0.1, seed=1), er_allocation(n, 4, 2)
    raise ValueError(model)


_CACHE = {}


def _cases(model):
    """(reference graph, allocation, port graph, port allocation)."""
    if model not in _CACHE:
        g, alloc = _case(model)
        _CACHE[model] = (g, alloc,
                         convert.graph(g.csr.indptr, g.csr.indices,
                                       g.csr.rows, g.edge_weights()),
                         convert.allocation(_fields(alloc)))
    return _CACHE[model]


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _same(a, b, what: str) -> None:
    """Every field of two dataclasses equal, arrays bitwise (dtype too)."""
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys(), what
    for k, va in fa.items():
        vb = fb[k]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, (what, k)
            np.testing.assert_array_equal(va, vb, err_msg=f"{what}.{k}")
        else:
            assert va == vb, (what, k, va, vb)


def _plans(model, shape):
    g, alloc, tg, ta = _cases(model)
    return (r_compile_h(g.csr, alloc, r_mesh.Topology(*shape)),
            t_compile_h(tg.csr, ta, t_mesh.Topology(*shape)))


def _assert_state(got, want, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    if name == "pagerank":
        np.testing.assert_allclose(got, want, **SUM_TOL)
    else:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _programs(name, n, B=1):
    if name == "pagerank":
        return r_algo.pagerank(), t_algo.pagerank()
    if B == 1:
        return r_algo.sssp(0), t_algo.sssp(0)
    roots = [0, 3, 11][:B]
    return r_algo.multi_sssp(roots), t_algo.multi_sssp(roots)


# ---- the engine's defaults are the reference's ----

@pytest.mark.parametrize("prog", ["pagerank", "sssp"])
@pytest.mark.parametrize("mode", ["single", "uncoded", "coded", "coded-fast"])
def test_engine_defaults_match_reference(mode, prog):
    g, alloc, tg, ta = _cases("er4")
    rprog, tprog = _programs(prog, g.n)
    want = r_engine.run(rprog, g, alloc, 3, mode=mode)
    got = t_engine.run(tprog, tg, ta, 3, mode=mode, device="cpu")
    _assert_state(got.state, want.state, prog)
    assert got.shuffle_bits == want.shuffle_bits
    eng = t_engine.compile(tprog, tg, ta, mode, device="cpu")
    assert (eng.path, eng.backend, eng.sparse) == ("auto", "numpy", True)


@pytest.mark.parametrize("prog", ["pagerank", "sssp"])
def test_engine_defaults_without_allocation(prog):
    g, _, tg, _ = _cases("er4")
    rprog, tprog = _programs(prog, g.n)
    want = r_engine.run(rprog, g, None, 3, mode="single")
    got = t_engine.run(tprog, tg, None, 3, mode="single", device="cpu")
    _assert_state(got.state, want.state, prog)
    assert got.shuffle_bits == want.shuffle_bits == 0


@pytest.mark.parametrize("mode", ["single", "uncoded", "coded", "coded-fast"])
def test_engine_defaults_take_the_dense_path_without_a_sparse_form(mode):
    g, alloc, tg, ta = _cases("er4")
    rprog = dataclasses.replace(r_algo.sssp(0), map_edge_values=None)
    tprog = dataclasses.replace(t_algo.sssp(0), map_edge_values=None)
    want = r_engine.run(rprog, g, alloc, 3, mode=mode)
    eng = t_engine.compile(tprog, tg, ta, mode, device="cpu")
    assert not eng.sparse
    got = eng.run(3)
    _assert_state(got.state, want.state, "sssp")
    assert got.shuffle_bits == want.shuffle_bits


# ---- the plan ----

@pytest.mark.parametrize("model,shape", CASES, ids=IDS)
def test_compile_hierarchical_matches_reference(model, shape):
    rh, th = _plans(model, shape)
    _same(th.flat, rh.flat, "flat")
    _same(th.inter, rh.inter, "inter")
    _same(th.rack_alloc, rh.rack_alloc, "rack_alloc")
    for k in ("rack_of", "inter_pos", "intra_src", "server_of_inter"):
        a, b = getattr(th, k), getattr(rh, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert th.intra_words == rh.intra_words
    assert (th.inter_rack_bits, th.intra_rack_bits) == (
        rh.inter_rack_bits, rh.intra_rack_bits)
    assert th.topology == t_mesh.Topology(*shape)


@pytest.mark.parametrize("model", ["er", "spill"])
def test_flat_topology_degenerates_and_one_rack_is_all_intra(model):
    g, alloc, tg, ta = _cases(model)
    K = ta.K
    flat = t_compile_h(tg.csr, ta, t_mesh.Topology.flat(K))
    _same(flat.inter, t_compile(tg.csr, ta), "inter vs compile_plan_csr")
    assert flat.intra_rack_bits == 0 and (flat.inter_pos >= 0).all()
    one = t_compile_h(tg.csr, ta, t_mesh.Topology(1, K))
    r_one = r_compile_h(g.csr, alloc, r_mesh.Topology(1, K))
    assert (one.inter_pos < 0).all() and one.inter_rack_bits == 0
    assert one.intra_rack_bits == r_one.intra_rack_bits > 0


def test_topology_matches_reference():
    for R, S in ((4, 2), (2, 4), (1, 8), (8, 1)):
        a, b = t_mesh.Topology(R, S), r_mesh.Topology(R, S)
        assert (a.K, a.is_flat) == (b.K, b.is_flat)
        for f in ("rack_of", "leader_of"):
            np.testing.assert_array_equal(getattr(a, f)(), getattr(b, f)())
        np.testing.assert_array_equal(a.servers_in(R - 1), b.servers_in(R - 1))
    assert t_mesh.Topology.flat(5) == t_mesh.Topology(5, 1)
    with pytest.raises(ValueError, match="need racks >= 1"):
        t_mesh.Topology(0, 2)
    with pytest.raises(ValueError, match="allocation expects K=6"):
        t_mesh.Topology(4, 2).check_K(6)


# ---- the partition ----

def _rflat(s, words: np.ndarray, rack: int) -> np.ndarray:
    """The reference's phase-A union buffer of one rack from [nnz + 1]
    words (the last one zero)."""
    S = s.S
    loc = words[s.loc_e[rack * S:(rack + 1) * S]]            # [S, Lmax]
    return np.concatenate([loc, np.zeros((S, 1), words.dtype)], 1).ravel()


@pytest.mark.parametrize("model,shape", CASES, ids=IDS)
def test_partition_hierarchical_matches_reference_and_packs(model, shape):
    g, alloc, tg, ta = _cases(model)
    rh, th = _plans(model, shape)
    want = r_fused.partition_hierarchical(rh, g.csr, alloc)
    got = t_fused.partition_hierarchical(th, tg.csr, ta)
    _same(got, want, "partition")
    p = t_fused.pack_hierarchical(got, tg.csr.nnz)
    book = p.book
    for tab, (shift, mask) in (("enc", (got.enc_shift, got.enc_mask)),
                               ("dec", (got.dec_shift, got.dec_mask)),
                               ("strip", (got.strip_shift, got.strip_mask))):
        code = getattr(p, f"{tab}_code")
        np.testing.assert_array_equal(book[0][code], shift)
        np.testing.assert_array_equal(book[1][code], mask)
    np.testing.assert_array_equal(p.dec_pos // (got.Wx + 1), got.dec_rk)
    np.testing.assert_array_equal(p.dec_pos % (got.Wx + 1), got.dec_w)
    # Every entry reads the word the reference's rflat position holds.
    words = np.random.default_rng(1).integers(
        1, 2 ** 32, size=tg.csr.nnz + 1, dtype=np.uint32)
    words[-1] = 0
    racks = np.arange(ta.K) // got.S
    for rho in range(got.R):
        np.testing.assert_array_equal(words[p.enc_e[rho]],
                                      _rflat(got, words, rho)[got.enc_l[rho]])
    for k in range(ta.K):
        rf = _rflat(got, words, racks[k])
        np.testing.assert_array_equal(words[p.strip_e[k]], rf[got.strip_f[k]])
        np.testing.assert_array_equal(words[p.direct_e[k]],
                                      rf[got.direct_l[k]] & got.direct_mask[k])


# ---- the exchange ----

@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("model,shape", CASES, ids=IDS)
def test_exchanges_deliver_the_reference_words(model, shape, B):
    g, alloc, tg, ta = _cases(model)
    rh, th = _plans(model, shape)
    rng = np.random.default_rng(B)
    shp = (g.csr.nnz, B) if B > 1 else (g.csr.nnz,)
    # Random finite bit patterns: every codec bit, the top bit included.
    ev = rng.standard_normal(shp).astype(np.float32) * np.float32(1e30)
    want = rh.execute_coded_sparse(ev, rh.edge_tables(g.csr, alloc))
    flat = rh.flat.execute_coded_sparse(ev, rh.flat.edge_tables(g.csr, alloc))
    np.testing.assert_array_equal(floats_to_words(want.values),
                                  floats_to_words(flat.values))
    fx = t_fused.FusedSparseShuffle(th, tg.csr, ta, device="cpu")
    got = fx.execute(ev)
    np.testing.assert_array_equal(floats_to_words(got.values),
                                  floats_to_words(want.values))
    assert got.bits_sent == want.bits_sent
    dp = HierarchicalDevicePlan(th, torch.device("cpu"),
                                th.edge_tables(tg.csr, ta))
    words = t_words_to_np(dp.words(torch.from_numpy(ev)))
    np.testing.assert_array_equal(words, floats_to_words(want.values))


def test_fused_binds_topologies_as_the_reference():
    g, alloc, tg, ta = _cases("er")
    th = t_compile_h(tg.csr, ta, t_mesh.Topology(4, 2))
    flat = t_compile(tg.csr, ta)
    fx = t_fused.FusedSparseShuffle(
        t_compile_h(tg.csr, ta, t_mesh.Topology.flat(8)), tg.csr, ta,
        device="cpu")
    ref = t_fused.FusedSparseShuffle(flat, tg.csr, ta, device="cpu")
    assert fx.hplan is None and fx.topology == t_mesh.Topology.flat(8)
    for k in ("enc_e", "enc_code", "dec_pos", "dec_code", "strip_e",
              "strip_code", "book", "ptr"):
        assert torch.equal(fx.tables[k], ref.tables[k]), k
    assert fx.tables.keys() == ref.tables.keys()
    with pytest.raises(ValueError, match="disagrees with the plan"):
        t_fused.FusedSparseShuffle(th, tg.csr, ta, device="cpu",
                                   topology=t_mesh.Topology(2, 4))
    with pytest.raises(ValueError, match="needs a HierarchicalPlan"):
        t_fused.FusedSparseShuffle(flat, tg.csr, ta, device="cpu",
                                   topology=t_mesh.Topology(4, 2))


# ---- the engine ----

@pytest.mark.parametrize("backend", ["numpy", "fused"])
@pytest.mark.parametrize("prog,B", [("pagerank", 1), ("sssp", 1), ("sssp", 3)])
@pytest.mark.parametrize("model,shape", CASES, ids=IDS)
def test_engine_topology_matches_reference(model, shape, prog, B, backend):
    g, alloc, tg, ta = _cases(model)
    rprog, tprog = _programs(prog, g.n, B)
    want = r_engine.run(rprog, g, alloc, 3, mode="coded",
                        topology=r_mesh.Topology(*shape))
    eng = t_engine.compile(tprog, tg, ta, "coded", path="sparse",
                           backend=backend, device="cpu",
                           topology=t_mesh.Topology(*shape))
    got = eng.run(3)
    _assert_state(got.state, want.state, prog)
    assert got.shuffle_bits == want.shuffle_bits
    ref = r_engine.compile(rprog, g, alloc, "coded",
                           topology=r_mesh.Topology(*shape))
    assert eng.loads() == ref.loads()
    assert eng.hplan is not None and eng.with_program(tprog).topology == \
        eng.topology
    assert eng.schedule_bits == (eng.hplan.inter_rack_bits
                                 + eng.hplan.intra_rack_bits)


@pytest.mark.parametrize("backend", ["numpy", "fused"])
def test_engine_flat_topology_is_the_flat_session(backend):
    g, alloc, tg, ta = _cases("sbm")
    flat = t_engine.run(t_algo.sssp(0), tg, ta, 4, path="sparse",
                        backend=backend, device="cpu")
    eng = t_engine.compile(t_algo.sssp(0), tg, ta, path="sparse",
                           backend=backend, device="cpu",
                           topology=t_mesh.Topology.flat(8))
    assert eng.hplan is None
    got = eng.run(4)
    np.testing.assert_array_equal(got.state.numpy().view(np.uint32),
                                  flat.state.numpy().view(np.uint32))
    assert got.shuffle_bits == flat.shuffle_bits
    assert eng.loads() == r_engine.compile(
        r_algo.sssp(0), g, alloc, topology=r_mesh.Topology.flat(8)).loads()


def _validation_cases():
    g, alloc, tg, ta = _cases("er")
    R, T = r_mesh.Topology, t_mesh.Topology
    rh = r_compile_h(g.csr, alloc, R(4, 2))
    th = t_compile_h(tg.csr, ta, T(4, 2))
    return [
        ({"mode": "uncoded", "topology": R(4, 2)},
         {"mode": "uncoded", "topology": T(4, 2)}),
        ({"path": "dense", "topology": R(4, 2)},
         {"path": "dense", "topology": T(4, 2)}),
        ({"backend": "spmv", "topology": R(4, 2)},
         {"backend": "spmv", "topology": T(4, 2)}),
        ({"alloc": None, "topology": R(4, 2)},
         {"alloc": None, "topology": T(4, 2)}),
        ({"topology": R(2, 3)}, {"topology": T(2, 3)}),
        ({"plan": rh, "topology": R(2, 4)}, {"plan": th, "topology": T(2, 4)}),
        ({"mode": "uncoded", "backend": "nope", "topology": R(4, 2)},
         {"mode": "uncoded", "backend": "nope", "topology": T(4, 2)}),
    ]


@pytest.mark.parametrize("case", range(7))
def test_topology_validation_in_the_reference_order(case):
    g, alloc, tg, ta = _cases("er")
    r_kw, t_kw = _validation_cases()[case]
    r_alloc = r_kw.pop("alloc", alloc)
    t_alloc = t_kw.pop("alloc", ta)
    with pytest.raises(ValueError) as r_exc:
        r_engine.compile(r_algo.pagerank(), g, r_alloc, **r_kw)
    with pytest.raises(ValueError) as t_exc:
        t_engine.compile(t_algo.pagerank(), tg, t_alloc, device="cpu", **t_kw)
    assert str(t_exc.value) == str(r_exc.value)


# ---- loads and the paper's closed forms ----

@pytest.mark.parametrize("model,kw,mk_alloc", [
    ("er", dict(n=60, p=0.15), lambda: er_allocation(60, 5, 2)),
    ("rb", dict(n1=36, n2=36, q=0.2), lambda: bipartite_allocation(36, 36, 6, 2)),
    ("sbm", dict(n1=30, n2=30, p=0.25, q=0.08),
     lambda: er_allocation(60, 5, 2, interleave=True)),
    ("pl", dict(n=60, gamma=2.5),
     lambda: er_allocation(60, 5, 2, interleave=True)),
])
def test_empirical_loads_match_reference(model, kw, mk_alloc):
    g = r_graphs.sample(model, seed=3, **kw)
    alloc = mk_alloc()
    tg = convert.graph(g.csr.indptr, g.csr.indices, g.csr.rows)
    ta = convert.allocation(_fields(alloc))
    want = r_loads.empirical_loads(g, alloc)
    assert t_loads.empirical_loads(tg, ta) == want
    assert t_loads.empirical_loads(tg.csr, ta) == want
    assert t_loads.empirical_loads(t_compile(tg.csr, ta), ta) == want
    with pytest.raises(TypeError):
        t_loads.empirical_loads(np.zeros((ta.n, ta.n), bool), ta)


@pytest.mark.parametrize("model,shape", CASES + [("er", (8, 1)), ("er", (1, 8))],
                         ids=IDS + ["er-8x1", "er-1x8"])
def test_empirical_loads_split_by_topology(model, shape):
    g, alloc, tg, ta = _cases(model)
    R, T = r_mesh.Topology(*shape), t_mesh.Topology(*shape)
    assert t_loads.empirical_loads(tg, ta, topology=T) == \
        r_loads.empirical_loads(g, alloc, topology=R)
    # The flat schedule laid on the fabric: the baseline of the split.
    assert t_loads.empirical_loads(t_compile(tg.csr, ta), ta, topology=T) == \
        r_loads.empirical_loads(r_compile(g.csr, alloc), alloc, topology=R)
    th = t_compile_h(tg.csr, ta, T)
    assert t_loads.empirical_loads(th, ta) == r_loads.empirical_loads(
        r_compile_h(g.csr, alloc, R), alloc)


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_closed_forms_match_reference(r):
    K, p, n = 5, 0.1, divisible_n(300, 5, r)
    for f in ("uncoded_load_er", "coded_load_er_asymptotic", "lower_bound_er"):
        assert getattr(t_loads, f)(p, r, K) == getattr(r_loads, f)(p, r, K)
    assert t_loads.coded_load_er_finite(n, p, r, K) == \
        r_loads.coded_load_er_finite(n, p, r, K)
    a_j = np.random.default_rng(r).integers(0, 20, size=K)
    assert t_loads.lower_bound_lemma3(p, a_j, 100, K) == \
        r_loads.lower_bound_lemma3(p, a_j, 100, K)
    assert t_loads.bounds_rb(0.2, r, 12) == r_loads.bounds_rb(0.2, r, 12)
    assert t_loads.achievable_sbm(30, 30, 0.25, 0.08, r, K) == \
        r_loads.achievable_sbm(30, 30, 0.25, 0.08, r, K)
    assert t_loads.lower_bound_sbm(0.08, r, K) == \
        r_loads.lower_bound_sbm(0.08, r, K)
    assert t_loads.achievable_pl(2.5, r, 10) == r_loads.achievable_pl(2.5, r, 10)
    assert t_loads.total_time_model(r, 1.0, 9.0, 0.5) == \
        r_loads.total_time_model(r, 1.0, 9.0, 0.5)
    assert t_loads.optimal_r(1.0, 9.0) == r_loads.optimal_r(1.0, 9.0) == 3.0


@pytest.mark.parametrize("model", ["er", "pl"])
def test_theorem1_loads_match_reference(model):
    """tests/test_theorem1.py's cases (K = 6, r 1..3) at n = 120."""
    g = (r_graphs.erdos_renyi(120, 0.3, seed=0) if model == "er"
         else r_graphs.power_law(120, 2.5, seed=0))
    tg = convert.graph(g.csr.indptr, g.csr.indices, g.csr.rows)
    for r in (1, 2, 3):
        alloc = er_allocation(120, 6, r)
        ta = convert.allocation(_fields(alloc))
        want = r_loads.empirical_loads(g, alloc)
        got = t_loads.empirical_loads(tg, ta)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k] == v or (math.isnan(v) and math.isnan(got[k])), k


# ---- roofline ----

def test_roofline_arithmetic_matches_reference():
    fig = t_mesh.card_figures("NVIDIA H100 80GB HBM3")
    assert fig.name == "H100 SXM" and fig.hbm_bw == 3.35e12
    assert t_mesh.card_figures("NVIDIA H100 PCIe").hbm_bw == 2.0e12
    for args in ((2e12, 3e9, 4e8, {"all-gather": 4e8}, 1),
                 (1e9, 5e10, 0.0, {}, 4)):
        want = r_roof.Roofline(*args, peak_flops=fig.bf16_flops,
                               hbm_bw=fig.hbm_bw, ici_bw=fig.link_bw)
        got = t_roof.Roofline(*args, peak_flops=fig.bf16_flops,
                              hbm_bw=fig.hbm_bw, link_bw=fig.link_bw)
        assert got.as_dict() == want.as_dict()
        assert got.step_time == want.step_time
        assert got.compute_fraction(1e12) == want.compute_fraction(1e12)
    for phase, roof in (("phase.map", "hbm"), ("encode", "hbm"),
                        ("phase.decode", "hbm"), ("reduce", "hbm")):
        want = r_roof.phase_roofline(phase, 2e-3, 5e9, chips=2)
        got = t_roof.phase_roofline(phase, 2e-3, 5e9, chips=2, figures=fig)
        assert got.roof == want.roof == roof and got.phase == want.phase
        ref = r_roof.PhaseRoofline(want.phase, 2e-3, 5e9, roof, chips=2,
                                   hbm_bw=fig.hbm_bw, ici_bw=fig.link_bw)
        assert got.as_dict() == ref.as_dict()
        assert got.roof_seconds == ref.roof_seconds
    four = t_roof.phase_roofline("exchange", 1e-3, 4e8, chips=4, figures=fig)
    assert four.roof == "nvlink" and four.fraction == pytest.approx(
        4e8 / 1e-3 / (4 * fig.link_bw))
    one = t_roof.phase_roofline("phase.exchange", 1e-3, 4e8, figures=fig)
    assert (one.roof, one.fraction, one.roof_seconds) == ("none", None, 0.0)
    with pytest.raises(ValueError, match="unknown phase"):
        t_roof.phase_roofline("phase.bogus", 1.0, 1.0, figures=fig)


def test_unknown_card_and_the_cpu_raise():
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 NVL", "TPU v5e"):
        with pytest.raises(ValueError, match="no published figures"):
            t_mesh.card_figures(name)
    with pytest.raises(ValueError, match="not a card"):
        t_roof.card_of("cpu")
    with pytest.raises(ValueError, match="not a card"):
        t_roof.phase_roofline("map", 1.0, 1.0, device="cpu")


# ---- K2's plain version with direct words ----

@pytest.mark.parametrize("r", [1, 2, 5])
@pytest.mark.parametrize("B", [1, 4])
def test_k2_direct_words_are_the_composition(r, B):
    """K2 with direct_e ORs src's word at each direct entry (zero for
    entries outside src) into the flat K2's words, on the CPU wrapper and
    the plain version alike."""
    rng = np.random.default_rng(10 * r + B)
    K, W, nnz, Dmax = 3, 17, 90, 11
    src = torch.from_numpy(rng.integers(0, 2 ** 32, size=(nnz, B) if B > 1
                                        else nnz, dtype=np.uint32).view(np.int32))
    counts = rng.integers(0, Dmax + 1, size=K)
    ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    code = lambda shape: torch.from_numpy(  # noqa: E731
        rng.integers(0, r + 2, size=shape).astype(np.uint8))
    book = torch.from_numpy(t_fused.code_book(r).view(np.int32))
    enc = (src, torch.from_numpy(rng.integers(0, nnz + 1, size=(K, W, r))
                                 .astype(np.int32)), code((K, W, r)), book)
    buf = xc.xor_encode_packed(*enc)
    dec = (torch.from_numpy(rng.integers(0, K * (W + 1), size=(K, Dmax, r))
                            .astype(np.int32)), code((K, Dmax, r)),
           torch.from_numpy(rng.integers(0, nnz + 1, size=(K, Dmax, r, r - 1))
                            .astype(np.int32)), code((K, Dmax, r, r - 1)), book,
           ptr)
    direct = torch.from_numpy(rng.integers(0, nnz + 3, size=(K, Dmax))
                              .astype(np.int32))
    flat = xref.xor_decode_packed(src, buf, *dec)
    got = xc.xor_decode_packed(src, buf, *dec, direct_e=direct)
    assert torch.equal(got, xref.xor_decode_packed(src, buf, *dec,
                                                   direct_e=direct))
    # The composition: flat words | bswap(src[direct_e]) per delivery.
    words = src.numpy().view(np.uint32).byteswap()
    words = np.concatenate([words, np.zeros((3,) + words.shape[1:], np.uint32)])
    d = direct.numpy()
    want = np.concatenate([words[d[k, :counts[k]]] for k in range(K)])
    want = flat.numpy().view(np.uint32) | want
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
