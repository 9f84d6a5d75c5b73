"""Port fused coded Shuffle + engine vs the reference package (on the CPU).

* Delivered words of the port's `FusedSparseShuffle` (virtual servers, the
  K1/K2 plain versions on the CPU) are bitwise equal to the reference's
  `ShufflePlan.execute_coded_sparse` over er/pl/sbm/rb x pagerank/sssp x
  spill x B in {1, 3}, with exact bits.
* `engine.compile(...).run(10)` of the port against the reference's
  `engine.run(..., mode="coded", path="sparse")`: bitwise for min/integer
  programs, within rtol 1e-5 for float sums (sequential sums against
  `np.add.reduceat`), `shuffle_bits` and `loads()` exactly equal.
* The packed session tables (`pack_schedule`) are lossless: unpacked, they
  give back every table of the port's `partition_plan` (itself bitwise the
  reference's) over er/pl/sbm/rb/spill x r in {1, 2, 3, 5} and the karate
  fixture, and the packed plain versions deliver words bitwise equal to
  `execute_coded_sparse` there at B in {1, 3}. A (shift, mask) pair
  outside the code book, or an entry past int32, raises.
* One subprocess with 4 forced host devices holds the port's words against
  the reference's `FusedSparseShuffle(..., encode="xor-kernel")`, the JAX
  route that reaches the Pallas kernel.
* No fallback: without CUDA, `device=None` (the card) raises.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import graphs as r_graphs
from repro.core import algorithms as r_algo
from repro.core import engine as r_engine
from repro.core.allocation import (bipartite_allocation, divisible_n,
                                   er_allocation)
from repro.core.bitcodec import floats_to_words
from repro.core.shuffle_plan import compile_plan_csr as r_compile
from repro.graphs.io import load_fixture
from repro_torch.core import algorithms as t_algo
from repro_torch.core import convert
from repro_torch.core import engine as t_engine
from repro_torch.core.fused_shuffle import (FusedSparseShuffle, pack_schedule,
                                            partition_plan)

SUM_RTOL = 1e-5


def _case(model):
    if model == "er":
        n = divisible_n(48, 4, 2)
        return r_graphs.erdos_renyi(n, 0.2, seed=11), er_allocation(n, 4, 2)
    if model == "pl":
        n = divisible_n(60, 4, 2)
        return r_graphs.power_law(n, 2.5, seed=9), er_allocation(n, 4, 2)
    if model == "rb":
        return (r_graphs.random_bipartite(48, 24, 0.3, seed=5),
                bipartite_allocation(48, 24, 6, 2))
    if model == "sbm":
        return (r_graphs.stochastic_block(48, 24, 0.25, 0.1, seed=5),
                bipartite_allocation(48, 24, 6, 2))
    if model == "spill":
        return (r_graphs.random_bipartite(48, 24, 0.3, seed=5),
                bipartite_allocation(48, 24, 6, 3))
    if model == "er-20k":
        n = divisible_n(20_000, 4, 2)
        return r_graphs.erdos_renyi(n, 8.0 / n, seed=21), er_allocation(n, 4, 2)
    raise ValueError(model)


def _port(g, alloc):
    csr = g.csr
    fields = {f.name: getattr(alloc, f.name)
              for f in dataclasses.fields(alloc)}
    return (convert.graph(csr.indptr, csr.indices, csr.rows,
                          g.edge_weights()),
            convert.allocation(fields))


def _programs(name, n, B):
    """(reference program, port program) of one name at batch width B."""
    rng = np.random.default_rng(n + B)
    if name == "pagerank" and B == 1:
        return r_algo.pagerank(), t_algo.pagerank()
    if name == "pagerank":
        prefs = rng.random((n, B)).astype(np.float32)
        prefs /= prefs.sum(axis=0)
        return (r_algo.personalized_pagerank(prefs),
                t_algo.personalized_pagerank(prefs))
    roots = [0, n // 3, n - 1][:B]
    if name == "sssp" and B == 1:
        return r_algo.sssp(0), t_algo.sssp(0)
    if name == "sssp":
        return r_algo.multi_sssp(roots), t_algo.multi_sssp(roots)
    if name == "cc":
        return r_algo.connected_components(), t_algo.connected_components()
    if name == "degree":
        return r_algo.degree_count(), t_algo.degree_count()
    raise ValueError(name)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("prog", ["pagerank", "sssp"])
@pytest.mark.parametrize("model", ["er", "pl", "sbm", "rb", "spill"])
def test_delivered_words_bitwise(model, prog, B):
    g, alloc = _case(model)
    tg, ta = _port(g, alloc)
    rprog, _ = _programs(prog, g.n, B)
    ev = rprog.map_edge_values(g, rprog.init(g)).astype(np.float32)
    plan = r_compile(g.csr, alloc)
    want = plan.execute_coded_sparse(ev, plan.edge_tables(g.csr, alloc))
    fx = FusedSparseShuffle(convert.shuffle_plan(
        {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}),
        tg.csr, ta, device="cpu")
    got = fx.execute(ev)
    np.testing.assert_array_equal(floats_to_words(got.values),
                                  floats_to_words(want.values))
    assert got.bits_sent == want.bits_sent
    for f in ("k", "i", "j", "ptr"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    # the device-tensor entry point delivers the same words
    words = fx.exchange(torch.from_numpy(ev))
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  floats_to_words(want.values))
    if model == "spill":
        assert plan.left_k.size > 0


def _r_case(model, r):
    """(graph, allocation) of the packing matrix at replication r: K = 6
    (spill: K = 4, whose cluster 2 spills at every r > 1); karate at its
    own K = 4, r = 2."""
    if model == "karate":
        g = load_fixture("karate")
        n = divisible_n(g.n, 4, 2)
        return g.padded(n), er_allocation(n, 4, 2)
    if model in ("er", "pl"):
        n = divisible_n(48 if model == "er" else 60, 6, r)
        g = (r_graphs.erdos_renyi(n, 0.2, seed=11) if model == "er"
             else r_graphs.power_law(n, 2.5, seed=9))
        return g, er_allocation(n, 6, r)
    g = (r_graphs.stochastic_block(48, 24, 0.25, 0.1, seed=5) if model == "sbm"
         else r_graphs.random_bipartite(48, 24, 0.3, seed=5))
    return g, bipartite_allocation(48, 24, 4 if model == "spill" else 6, r)


_PACK_CASES = [(m, r) for m in ("er", "pl", "sbm", "rb", "spill")
               for r in (1, 2, 3, 5)] + [("karate", 2)]


def _schedule(model, r):
    g, alloc = _r_case(model, r)
    tg, ta = _port(g, alloc)
    rplan = r_compile(g.csr, alloc)
    plan = convert.shuffle_plan({f.name: getattr(rplan, f.name)
                                 for f in dataclasses.fields(rplan)})
    return g, alloc, rplan, plan, tg, ta


def _unpack(p, s, nnz):
    """The `FusedSparseSchedule` tables packed tables `p` stand for: codes
    looked up in the book, positions split into (sender, column), entries
    mapped back to local indices through each server's sorted Map slice."""
    def local(e):
        out = np.empty(e.shape, np.int64)
        for k in range(s.K):
            lset = s.loc_e[k][s.loc_e[k] < nnz]
            li = np.searchsorted(lset, e[k])
            out[k] = np.where(e[k] == nnz, s.Lmax, li)
            assert np.array_equal(lset[np.minimum(li, lset.size - 1)][e[k] < nnz],
                                  e[k][e[k] < nnz])
        return out

    book = p.book
    return dict(
        enc_l=local(p.enc_e), enc_shift=book[0][p.enc_code],
        enc_mask=book[1][p.enc_code],
        dec_s=p.dec_pos // (s.W + 1), dec_w=p.dec_pos % (s.W + 1),
        dec_shift=book[0][p.dec_code], dec_mask=book[1][p.dec_code],
        strip_l=local(p.strip_e), strip_shift=book[0][p.strip_code],
        strip_mask=book[1][p.strip_code])


@pytest.mark.parametrize("model,r", _PACK_CASES,
                         ids=[f"{m}-r{r}" for m, r in _PACK_CASES])
def test_packing_is_lossless(model, r):
    _, _, _, plan, tg, ta = _schedule(model, r)
    s = partition_plan(plan, tg.csr, ta)
    assert s.r == r
    p = pack_schedule(s, tg.csr.nnz)
    assert p.book.shape == (2, r + 2)
    for name, table in _unpack(p, s, tg.csr.nnz).items():
        np.testing.assert_array_equal(table, getattr(s, name), err_msg=name)
    if model == "spill" and r > 1:
        assert plan.left_k.size > 0 and (p.enc_code == r).any()


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("model,r", _PACK_CASES,
                         ids=[f"{m}-r{r}" for m, r in _PACK_CASES])
def test_packed_words_bitwise_over_r(model, r, B):
    g, alloc, rplan, plan, tg, ta = _schedule(model, r)
    rng = np.random.default_rng(r + B)
    ev = rng.standard_normal((g.csr.nnz, B) if B > 1 else g.csr.nnz
                             ).astype(np.float32)
    want = rplan.execute_coded_sparse(ev, rplan.edge_tables(g.csr, alloc))
    got = FusedSparseShuffle(plan, tg.csr, ta, device="cpu").execute(ev)
    np.testing.assert_array_equal(floats_to_words(got.values),
                                  floats_to_words(want.values))
    assert got.bits_sent == want.bits_sent


@pytest.mark.parametrize("table", ["enc", "dec", "strip", "nnz"])
def test_packing_refuses_what_the_book_cannot_name(table):
    _, _, _, plan, tg, ta = _schedule("rb", 3)    # pairs and leftovers
    s = partition_plan(plan, tg.csr, ta)
    if table == "nnz":
        with pytest.raises(ValueError, match="int32"):
            pack_schedule(s, 2 ** 31)
        return
    mask = getattr(s, f"{table}_mask").copy()
    idx = tuple(np.argwhere(mask != 0)[0])
    mask[idx] ^= 1                                # one bit off its segment
    bad = dataclasses.replace(s, **{f"{table}_mask": mask})
    with pytest.raises(ValueError, match="not in the code book"):
        pack_schedule(bad, tg.csr.nnz)


@pytest.mark.parametrize("K,r", [(34, 33), (64, 64)])
def test_sessions_past_32_segments(K, r):
    """r > 32 (K <= 64): zero-width segments (mask 0, shift clipped to 31)
    are codes of a book of r + 2 <= 66 pairs. Delivered words bitwise
    `execute_coded_sparse`, sssp bitwise `reference_run`, pagerank within
    rtol 1e-5, exact bits."""
    n = divisible_n(2 * K, K, r)
    g = r_graphs.erdos_renyi(n, 0.1, seed=K)
    alloc = er_allocation(n, K, r)
    tg, ta = _port(g, alloc)
    rplan = r_compile(g.csr, alloc)
    ev = np.random.default_rng(r).standard_normal(g.csr.nnz).astype(np.float32)
    want = rplan.execute_coded_sparse(ev, rplan.edge_tables(g.csr, alloc))
    eng = t_engine.compile(t_algo.sssp(0), tg, ta, path="sparse",
                           backend="fused", device="cpu")
    assert eng.fused.packed.book.shape == (2, r + 2)
    assert (eng.fused.packed.book[1][:r] == 0).any()    # zero-width segments
    got = eng.fused.execute(ev)
    np.testing.assert_array_equal(floats_to_words(got.values),
                                  floats_to_words(want.values))
    assert got.bits_sent == want.bits_sent
    res = eng.run(10)
    oracle = r_algo.reference_run(r_algo.sssp(0), g, 10, path="sparse")
    np.testing.assert_array_equal(res.state.numpy().view(np.uint32),
                                  oracle.view(np.uint32))
    pr = eng.with_program(t_algo.pagerank()).run(10)
    np.testing.assert_allclose(
        pr.state.numpy(), r_algo.reference_run(r_algo.pagerank(), g, 10,
                                               path="sparse"),
        rtol=SUM_RTOL, atol=0)
    assert res.shuffle_bits == 10 * (rplan.coded_bits + rplan.leftover_bits)


def _check_run(model, prog, B, iters=10):
    g, alloc = _case(model)
    tg, ta = _port(g, alloc)
    rprog, tprog = _programs(prog, g.n, B)
    want = r_engine.run(rprog, g, alloc, iters, mode="coded", path="sparse")
    eng = t_engine.compile(tprog, tg, ta, path="sparse", backend="fused",
                           device="cpu")
    got = eng.run(iters)
    st = got.state.numpy()
    assert st.shape == want.state.shape and st.dtype == np.float32
    if tprog.reduce_op == "sum":
        np.testing.assert_allclose(st, want.state, rtol=SUM_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(st.view(np.uint32),
                                      want.state.view(np.uint32))
    assert got.shuffle_bits == want.shuffle_bits
    assert got.normalized_load == want.normalized_load
    return g, alloc, eng


@pytest.mark.parametrize("prog,B", [("pagerank", 1), ("sssp", 1), ("cc", 1),
                                    ("degree", 1), ("pagerank", 3),
                                    ("sssp", 3)])
@pytest.mark.parametrize("model", ["er", "pl", "sbm", "spill"])
def test_engine_matches_reference(model, prog, B):
    _check_run(model, prog, B)


def test_engine_20k_pagerank_and_sssp():
    g, alloc, eng = _check_run("er-20k", "pagerank", 1)
    ref = r_engine.run(r_algo.sssp(0), g, alloc, 10, mode="coded",
                       path="sparse")
    got = eng.with_program(t_algo.sssp(0)).run(10)
    np.testing.assert_array_equal(got.state.numpy().view(np.uint32),
                                  ref.state.view(np.uint32))
    assert got.shuffle_bits == ref.shuffle_bits


def test_loads_with_program_and_run_batch():
    g, alloc = _case("er")
    tg, ta = _port(g, alloc)
    eng = t_engine.compile(t_algo.pagerank(), tg, ta, path="sparse",
                           backend="fused", device="cpu")
    ref = r_engine.compile(r_algo.pagerank(), g, alloc, "coded")
    assert eng.loads() == ref.loads()
    roots = [0, 5, 17]
    multi = eng.with_program(t_algo.multi_sssp(roots))
    assert multi.plan is eng.plan and multi.fused is eng.fused
    cols = [t_algo.sssp(s).init(tg) for s in roots]
    res = multi.run_batch(cols, 10)
    want = r_engine.run(r_algo.multi_sssp(roots), g, alloc, 10, mode="coded",
                        path="sparse")
    np.testing.assert_array_equal(res.state.numpy().view(np.uint32),
                                  want.state.view(np.uint32))
    assert res.batch == 3
    assert res.shuffle_bits == 3 * 10 * (eng.plan.coded_bits
                                         + eng.plan.leftover_bits)
    with pytest.raises(ValueError, match="states must be"):
        multi.run_batch(np.zeros((g.n + 1, 2), np.float32), 1)


def test_no_fallback_without_cuda(monkeypatch):
    g, alloc = _case("er")
    tg, ta = _port(g, alloc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            t_engine.compile(t_algo.pagerank(), tg, ta, path="sparse",
                             backend="fused", device=device)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            t_engine.run(t_algo.pagerank(), tg, ta, 1, path="sparse",
                         backend="fused", device=device)


@pytest.mark.parametrize("call,match", [
    (lambda eng: eng.run(1, fault_schedule=object()), "Queue 1 #9"),
    (lambda eng: eng.run(1, checkpoint=object()), "Queue 1 #9"),
    (lambda eng: eng.fail((0,)), "Queue 1 #9"),
    (lambda eng: eng.update(object()), "Queue 1 #9"),
    (lambda eng: t_engine.restore("ckpt", eng.program, eng.g), "Queue 1 #9"),
], ids=["fault_schedule", "checkpoint", "fail", "update", "restore"])
def test_unported_options_name_their_roadmap_item(call, match):
    g, alloc = _case("er")
    tg, ta = _port(g, alloc)
    eng = t_engine.compile(t_algo.pagerank(), tg, ta, path="sparse",
                           backend="fused", device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        call(eng)


def test_fused_backend_outside_mode_coded_raises_as_the_reference():
    g, alloc = _case("er")
    tg, ta = _port(g, alloc)
    with pytest.raises(ValueError, match="use mode='coded'"):
        r_engine.compile(r_algo.pagerank(), g, alloc, "uncoded",
                         backend="fused")
    with pytest.raises(ValueError, match="use mode='coded'"):
        t_engine.compile(t_algo.pagerank(), tg, ta, "uncoded", path="sparse",
                         backend="fused", device="cpu")


SCRIPT_PALLAS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import numpy as np
from repro import graphs
from repro.core import algorithms as algo
from repro.core.allocation import divisible_n, er_allocation
from repro.core.bitcodec import floats_to_words
from repro.core.fused_shuffle import FusedSparseShuffle as RefShuffle
from repro.core.shuffle_plan import compile_plan_csr
from repro_torch.core import convert
from repro_torch.core.fused_shuffle import FusedSparseShuffle

out = {}
for model, g in (("er", graphs.erdos_renyi(divisible_n(48, 4, 2), 0.2, seed=11)),
                 ("pl", graphs.power_law(divisible_n(60, 4, 2), 2.5, seed=9))):
    alloc = er_allocation(g.n, 4, 2)
    plan = compile_plan_csr(g.csr, alloc)
    ref = RefShuffle(plan, g.csr, alloc, encode="xor-kernel")
    f = lambda o: {x.name: getattr(o, x.name) for x in dataclasses.fields(o)}
    port = FusedSparseShuffle(
        convert.shuffle_plan(f(plan)),
        convert.graph(g.csr.indptr, g.csr.indices, g.csr.rows).csr,
        convert.allocation(f(alloc)), device="cpu")
    for prog in (algo.pagerank(), algo.sssp(0)):
        ew = floats_to_words(prog.map_edge_values(g, prog.init(g))
                             .astype(np.float32))
        out[f"{model}_{prog.name}"] = bool(np.array_equal(
            ref.exchange_words(ew), port.exchange_words(ew)))
    ew3 = np.random.default_rng(1).integers(0, 2**32, (g.csr.nnz, 3),
                                            dtype=np.uint32)
    out[f"{model}_B3"] = bool(np.array_equal(ref.exchange_words(ew3),
                                             port.exchange_words(ew3)))
print(json.dumps(out))
"""


def test_words_bitwise_vs_reference_pallas_route_4_devices():
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT_PALLAS],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res and all(res.values()), res
