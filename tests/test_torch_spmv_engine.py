"""Port engine `backend="spmv"` vs the reference package, on the CPU.

The port's `engine.compile(..., backend="spmv", device="cpu")` (K5's plain
version on the CPU) is held against the reference's `backend="spmv"`
route (the Pallas kernel in interpret mode over densified row strips) and
against its default NumPy backend:

* pagerank and degree x the four modes x er and pl, personalized pagerank
  at B = 3 in every mode, and `bm=32` inline against `backend_opts`;
* state within rtol 1e-5 (atol 1e-8): the sums run in another order than
  the Pallas tiles and `np.add.reduceat`; degree counts are exact, so
  bitwise;
* `shuffle_bits` exactly equal, and `loads()` equal or raising the same
  error (an uncoded plan has no schedule; a single session has no plan);
* the reference's errors: nonlinear programs, `path="dense"`, unknown
  options, `backend="fused"` outside mode "coded";
* the device per-source Map (`map_source_t`) bitwise the reference's
  `map_source` at B = 1 and 3.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import graphs as r_graphs
from repro.core import algorithms as r_algo
from repro.core import engine as r_engine
from repro.core.allocation import divisible_n, er_allocation
from repro_torch.core import algorithms as t_algo
from repro_torch.core import convert
from repro_torch.core import engine as t_engine

MODES = ("single", "uncoded", "coded", "coded-fast")
TOL = dict(rtol=1e-5, atol=1e-8)


def _case(model):
    if model == "er":
        n = divisible_n(48, 4, 2)
        g = r_graphs.erdos_renyi(n, 0.2, seed=11)
    else:
        n = divisible_n(60, 4, 2)
        g = r_graphs.power_law(n, 2.5, seed=9)
    alloc = er_allocation(n, 4, 2)
    fields = {f.name: getattr(alloc, f.name)
              for f in dataclasses.fields(alloc)}
    port = (convert.graph(g.csr.indptr, g.csr.indices, g.csr.rows,
                          g.edge_weights()), convert.allocation(fields))
    return g, alloc, port


def _programs(name, n):
    if name == "pagerank":
        return r_algo.pagerank(), t_algo.pagerank()
    if name == "degree":
        return r_algo.degree_count(), t_algo.degree_count()
    prefs = np.random.default_rng(n).random((n, 3)).astype(np.float32)
    prefs /= prefs.sum(axis=0)
    return (r_algo.personalized_pagerank(prefs),
            t_algo.personalized_pagerank(prefs))


def _loads(eng):
    try:
        return eng.loads()
    except ValueError as exc:
        return ("ValueError", str(exc))


def _check(model, prog, mode, iters=10, **opts):
    g, alloc, (tg, ta) = _case(model)
    rprog, tprog = _programs(prog, g.n)
    ref = r_engine.compile(rprog, g, alloc, mode, backend="spmv", **opts)
    want = ref.run(iters)
    numpy_backend = r_engine.run(rprog, g, alloc, iters, mode=mode,
                                 path="sparse")
    eng = t_engine.compile(tprog, tg, ta, mode, backend="spmv",
                           device="cpu", **opts)
    got = eng.run(iters)
    st = got.state.numpy()
    assert st.shape == want.state.shape and st.dtype == np.float32
    if prog == "degree":
        np.testing.assert_array_equal(st.view(np.uint32),
                                      want.state.view(np.uint32))
    np.testing.assert_allclose(st, want.state, **TOL)
    np.testing.assert_allclose(st, numpy_backend.state, **TOL)
    assert got.shuffle_bits == want.shuffle_bits == numpy_backend.shuffle_bits
    assert got.normalized_load == want.normalized_load
    assert _loads(eng) == _loads(ref)
    return eng, got


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("prog", ["pagerank", "degree", "ppr"])
def test_map_source_t_bitwise_the_reference_map_source(prog, B):
    g, _, (tg, _) = _case("pl")
    rprog, tprog = _programs(prog, g.n)
    shape = (g.n, B) if B > 1 else (g.n,)
    state = np.random.default_rng(B).random(shape).astype(np.float32)
    want = rprog.map_source(g, state)
    got = tprog.map_source_t(tg.device_view("cpu"), torch.from_numpy(state))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("prog", ["pagerank", "degree"])
@pytest.mark.parametrize("model", ["er", "pl"])
def test_spmv_route_matches_reference(model, prog, mode):
    _check(model, prog, mode)


@pytest.mark.parametrize("mode", MODES)
def test_spmv_route_batched_ppr(mode):
    eng, got = _check("er", "ppr", mode, iters=4, bm=32)
    assert got.batch == 3
    assert got.shuffle_bits == 3 * 4 * eng.schedule_bits


def test_spmv_bits_per_mode_summed_at_build():
    g, alloc, (tg, ta) = _case("er")
    bits = {}
    for mode in MODES:
        eng = t_engine.compile(t_algo.pagerank(), tg, ta, mode,
                               backend="spmv", device="cpu")
        bits[mode] = eng.schedule_bits
        if mode != "single":
            assert eng.tables is not None     # the coverage check ran
    plan = r_engine.compile(r_algo.pagerank(), g, alloc, "coded").plan
    assert bits == {"single": 0, "uncoded": plan.uncoded_bits,
                    "coded": plan.coded_bits + plan.leftover_bits,
                    "coded-fast": plan.coded_bits}
    single = t_engine.compile(t_algo.pagerank(), tg, None, "single",
                              backend="spmv", device="cpu")
    assert single.plan is None and single.run(2).shuffle_bits == 0


def test_spmv_inline_bm_equals_backend_opts():
    g, alloc, (tg, ta) = _case("pl")
    a = t_engine.compile(t_algo.pagerank(), tg, ta, "coded", backend="spmv",
                         bm=32, device="cpu").run(2)
    b = t_engine.run(t_algo.pagerank(), tg, ta, 2, backend="spmv",
                     backend_opts={"bm": 32}, device="cpu")
    assert np.array_equal(a.state.numpy(), b.state.numpy())
    want = r_engine.run(r_algo.pagerank(), g, alloc, 2, backend="spmv",
                        backend_opts={"bm": 32})
    np.testing.assert_allclose(a.state.numpy(), want.state, **TOL)


def test_spmv_with_program_and_run_batch():
    g, alloc, (tg, ta) = _case("er")
    eng = t_engine.compile(t_algo.pagerank(), tg, ta, "coded",
                           backend="spmv", device="cpu")
    prefs = t_algo.uniform_prefs(g.n, 2)
    ppr = eng.with_program(t_algo.personalized_pagerank(prefs))
    assert ppr.plan is eng.plan and ppr._indices is eng._indices
    res = ppr.run_batch([prefs[:, 0], prefs[:, 1]], 5)
    want = r_engine.compile(
        r_algo.personalized_pagerank(r_algo.uniform_prefs(g.n, 2)), g, alloc,
        "coded", backend="spmv").run_batch(
            [prefs[:, 0], prefs[:, 1]], 5)
    np.testing.assert_allclose(res.state.numpy(), want.state, **TOL)
    assert res.shuffle_bits == want.shuffle_bits
    with pytest.raises(ValueError, match="not linear"):
        eng.with_program(t_algo.sssp(0))


@pytest.mark.parametrize("kw,match", [
    (dict(backend="spmv", prog="sssp"), "not linear"),
    (dict(backend="spmv", prog="cc"), "not linear"),
    (dict(backend="spmv", path="dense"), "sparse"),
    (dict(backend="spmv", mode="coded-ref", path="auto"), "sparse"),
    (dict(backend="spmv", mesh=None), r"accepted: \['bm'\]"),
    (dict(backend="spmv", backend_opts={"interpret": True}),
     r"accepted: \['bm'\]"),
    (dict(backend="spmv", bm=48), "power of two"),
    (dict(backend="fused", bm=8), r"accepted: \(none\)"),
    (dict(backend="fused", mode="single"), "use mode='coded'"),
    (dict(backend="fused", mode="uncoded"), "use mode='coded'"),
    (dict(backend="fused", mode="coded-fast"), "use mode='coded'"),
    (dict(backend="cuda"), "unknown backend"),
    (dict(mode="bogus"), "unknown mode"),
    (dict(path="bogus"), "unknown path"),
])
def test_spmv_and_mode_errors_as_the_reference(kw, match):
    g, alloc, (tg, ta) = _case("er")
    progs = {"sssp": t_algo.sssp(0), "cc": t_algo.connected_components()}
    prog = progs[kw.pop("prog")] if "prog" in kw else t_algo.pagerank()
    with pytest.raises(ValueError, match=match):
        t_engine.compile(prog, tg, ta, device="cpu", **kw)


def test_reference_raises_the_same_errors():
    """The error cases above mirror the reference's own ValueErrors."""
    g, alloc, _ = _case("er")
    with pytest.raises(ValueError, match="not linear"):
        r_engine.compile(r_algo.sssp(0), g, alloc, backend="spmv")
    with pytest.raises(ValueError, match="sparse"):
        r_engine.compile(r_algo.pagerank(), g, alloc, path="dense",
                         backend="spmv")
    with pytest.raises(ValueError, match="use mode='coded'"):
        r_engine.compile(r_algo.pagerank(), g, alloc, "uncoded",
                         backend="fused")
