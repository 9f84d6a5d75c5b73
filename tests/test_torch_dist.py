"""The fused exchange across processes (`FusedSparseShuffle(..., group=)`)
on gloo, CPU ranks spawned here.

Each case spawns P ranks of one `torch.distributed` group (a `FileStore`
in a temporary directory, so no port is opened) running K servers, K / P
per rank. On every rank:

* one exchange's delivered words, at B = 1 and B = 4, are bitwise
  `ShufflePlan.execute_coded_sparse`;
* pagerank, sssp and multi_sssp (B = 4) for 5 iterations are bitwise the
  single-process `device="cpu"` fused session's, with its bits (the
  virtual route's);
* `update` by an `EdgeDelta` keeps the group and stays bitwise the
  single-process session's update.

The ranks' words and states are then compared with each other (each rank
Maps and Reduces its own share and gathers the reduced rows, so every
rank holds the same bits) and with
the JAX package's on the same graph: the words bitwise its
`execute_coded_sparse`, sssp and multi_sssp bitwise its `reference_run`,
pagerank within rtol 1e-5 of it. The world-2 case
also checks what raises: K % P != 0, a two-level layout that neither
gives each rank whole racks nor splits each rack evenly, an unknown
option.

The two-level exchange on a group (`HIER_CASES`: world 2 on
`Topology(2, 2)` and world 4 on `(4, 2)`, where a rank owns whole racks;
world 4 on `(2, 2)` and `(2, 4)`, where a rack spans two ranks): on every
rank one exchange's words at B = 1 and 4 bitwise the flat plan's
`execute_coded_sparse`, the exchange span's per-level bits (with `ranks`)
and the registry's counters exactly the plan's, pagerank / sssp /
multi_sssp for 5 iterations bitwise the single-process two-level fused
session's with its bits, and `update` keeping the group; then, in this
process, the words bitwise the JAX package's `execute_coded_sparse`, the
per-level bits its `compile_hierarchical`'s, sssp and multi_sssp bitwise
its `reference_run`.
"""
import pathlib
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import graphs
from repro_torch.core import algorithms as algo
from repro_torch.core import engine
from repro_torch.core.allocation import divisible_n, er_allocation
from repro_torch.core.bitcodec import floats_to_words, t_words_to_np
from repro_torch.core.fused_shuffle import FusedSparseShuffle
from repro_torch.core.shuffle_plan import compile_hierarchical, compile_plan_csr
from repro_torch.launch.mesh import Topology
from repro_torch.obs import get_registry, get_tracer

TIMEOUT_S = 120
ITERS = 5
# (world P, servers K, r, base n, seed)
CASES = [(2, 4, 2, 240, 3), (4, 4, 2, 240, 5), (4, 8, 3, 420, 7)]


def _session(g, alloc, plan, prog, group=None, **opts):
    return engine.compile(prog, g, alloc, "coded", path="sparse",
                          backend="fused", plan=plan, device="cpu",
                          group=group, **opts)


def _bitwise(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), what


def _delta(g, seed):
    rng = np.random.default_rng(seed)
    csr = g.csr
    upper = np.flatnonzero(csr.rows < csr.indices)
    pick = rng.choice(upper, size=8, replace=False)
    dels = np.stack([csr.rows[pick], csr.indices[pick]], axis=1)
    have = set(zip(csr.rows.tolist(), csr.indices.tolist()))
    ins = []
    while len(ins) < 8:
        u, v = sorted(rng.integers(0, g.params.get("padded_from", g.n), size=2).tolist())
        if u != v and (u, v) not in have and [u, v] not in ins:
            ins.append([u, v])
    return graphs.EdgeDelta.for_graph(g, insert=np.array(ins), delete=dels)


def _check_raises(group, g0):
    import torch.distributed as dist

    P = dist.get_world_size(group)
    K = 2 * P + 1                                   # not a multiple of P
    n = divisible_n(g0.n, K, 2)
    g, alloc = g0.padded(n), er_allocation(n, K, 2)
    with pytest.raises(ValueError, match="divide"):
        _session(g, alloc, None, algo.pagerank(), group)
    # Three racks over two ranks: neither whole racks per rank nor an even
    # split of each rack.
    n = divisible_n(g0.n, 6, 2)
    g, alloc = g0.padded(n), er_allocation(n, 6, 2)
    with pytest.raises(ValueError, match="P divides R"):
        engine.compile(algo.pagerank(), g, alloc, "coded", path="sparse",
                       backend="fused", device="cpu", group=group,
                       topology=Topology(3, 2))
    hplan = compile_hierarchical(g.csr, alloc, Topology(3, 2))
    with pytest.raises(ValueError, match="P divides R"):
        FusedSparseShuffle(hplan, g.csr, alloc, device="cpu", group=group)
    n = divisible_n(g0.n, 4, 2)
    g, alloc = g0.padded(n), er_allocation(n, 4, 2)
    with pytest.raises(ValueError, match="unknown option"):
        _session(g, alloc, None, algo.pagerank(), group, mesh=None)


def _case_graph(case):
    """(unpadded graph, padded graph, allocation) of a case."""
    P, K, r, n_base, seed = case
    g0 = graphs.erdos_renyi(n_base, 8.0 / (n_base - 1), seed=seed)
    n = divisible_n(g0.n, K, r)
    return g0, g0.padded(n), er_allocation(n, K, r)


def _inputs(prog, g, seed):
    """One exchange's Map outputs: pagerank's at B = 1, seeded at B = 4."""
    ev = prog.map_edge_values(g, prog.init(g)).astype(np.float32)
    return ev, np.random.default_rng(seed).random((g.csr.nnz, 4), dtype=np.float32)


def _roots(n):
    return [0, n // 3, n // 2, n - 1]


def _check_rank(case, group) -> dict:
    P, K, r, n_base, seed = case
    g0, g, alloc = _case_graph(case)
    n = g.n
    plan = compile_plan_csr(g.csr, alloc)
    prog = algo.pagerank()
    single = _session(g, alloc, plan, prog)
    multi = _session(g, alloc, plan, prog, group)
    assert multi.fused.shard.world == P and multi.fused.M == single.fused.M

    out = {}
    for B, vals in zip((1, 4), _inputs(prog, g, seed)):
        want = floats_to_words(plan.execute_coded_sparse(vals, single.tables).values)
        got = out[f"words_b{B}"] = t_words_to_np(
            multi.fused.exchange(torch.from_numpy(vals)))
        assert np.array_equal(got, want), f"words, B = {B}"

    for name, p in (("pagerank", prog), ("sssp", algo.sssp(0)),
                    ("multi_sssp", algo.multi_sssp(_roots(n)))):
        a = single.with_program(p).run(ITERS)
        b = multi.with_program(p).run(ITERS)
        _bitwise(b.state.numpy(), a.state.numpy(), name)
        assert b.shuffle_bits == a.shuffle_bits, name
        out[name] = b.state.numpy()

    delta = _delta(g, seed)
    su, mu = single.update(delta), multi.update(delta)
    assert mu.fused.group is group and mu.fused.shard.world == P
    a, b = su.run(ITERS), mu.run(ITERS)
    _bitwise(b.state.numpy(), a.state.numpy(), "pagerank after update")
    assert b.shuffle_bits == a.shuffle_bits
    out["updated"] = b.state.numpy()
    if P == 2:
        _check_raises(group, g0)
    return out


# (world P, (racks R, servers per rack S), r, base n, seed); K = R S
HIER_CASES = [(2, (2, 2), 2, 240, 3), (4, (2, 2), 2, 240, 5),
              (4, (4, 2), 2, 420, 7), (4, (2, 4), 2, 420, 9)]


def _hier_graph(case):
    """(padded graph, allocation, topology) of a two-level case."""
    P, (R, S), r, n_base, seed = case
    g0 = graphs.erdos_renyi(n_base, 8.0 / (n_base - 1), seed=seed)
    n = divisible_n(g0.n, R * S, r)
    return g0.padded(n), er_allocation(n, R * S, r), Topology(R, S)


def _exchange_span_bits(ex, vals) -> dict:
    """One traced exchange of `vals`: its words, the exchange span's
    attributes and the registry's per-level counters' increments."""
    reg, tr = get_registry(), get_tracer()
    names = ("shuffle_inter_rack_bits_total", "shuffle_intra_rack_bits_total")
    before = [reg.counter(n, "").value for n in names]
    tr.reset().enable()
    try:
        words = ex.exchange(torch.from_numpy(vals))
    finally:
        tr.disable()
    (span,) = tr.find("phase.exchange")
    tr.reset()
    after = [reg.counter(n, "").value for n in names]
    return {"words": t_words_to_np(words), "span": dict(span.attrs),
            "counters": [a - b for a, b in zip(after, before)]}


def _check_hier_rank(case, group) -> dict:
    P = case[0]
    g, alloc, topo = _hier_graph(case)
    hplan = compile_hierarchical(g.csr, alloc, topo)
    plan = hplan.flat
    prog = algo.pagerank()
    single = _session(g, alloc, hplan, prog)
    multi = _session(g, alloc, hplan, prog, group)
    fx = multi.fused
    assert fx.racks is not None and fx.shard.world == P
    assert fx.racks.per_rack == max(1, P // topo.racks)
    tables = plan.edge_tables(g.csr, alloc)
    inter, intra = hplan.inter_rack_bits, hplan.intra_rack_bits
    out = {"rack_bits": np.array([inter, intra], dtype=np.int64)}
    for B, vals in zip((1, 4), _inputs(prog, g, case[-1])):
        want = floats_to_words(plan.execute_coded_sparse(vals, tables).values)
        got = _exchange_span_bits(fx, vals)
        assert np.array_equal(got["words"], want), f"words, B = {B}"
        assert np.array_equal(t_words_to_np(single.fused.exchange(
            torch.from_numpy(vals))), want), f"virtual words, B = {B}"
        span = got["span"]
        assert (span["inter_rack_bits"], span["intra_rack_bits"]) == (
            inter * B, intra * B), span
        assert span["bits"] == (inter + intra) * B and span["ranks"] == P
        assert got["counters"] == [inter * B, intra * B]
        out[f"words_b{B}"] = got["words"]

    for name, p in (("pagerank", prog), ("sssp", algo.sssp(0)),
                    ("multi_sssp", algo.multi_sssp(_roots(g.n)))):
        a = single.with_program(p).run(ITERS)
        b = multi.with_program(p).run(ITERS)
        _bitwise(b.state.numpy(), a.state.numpy(), name)
        assert b.shuffle_bits == a.shuffle_bits == (inter + intra) * a.batch * ITERS
        out[name] = b.state.numpy()

    delta = _delta(g, case[-1])
    su, mu = single.update(delta), multi.update(delta)
    assert mu.fused.group is group and mu.fused.racks is fx.racks
    assert mu.hplan is not None
    a, b = su.run(ITERS), mu.run(ITERS)
    _bitwise(b.state.numpy(), a.state.numpy(), "pagerank after update")
    assert b.shuffle_bits == a.shuffle_bits
    out["updated"] = b.state.numpy()
    return out


def _rank_main(rank, case, tmp, check):
    import torch.distributed as dist

    torch.set_num_threads(1)
    world = case[0]
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world),
                            rank=rank, world_size=world)
    try:
        np.savez(tmp / f"rank{rank}.npz", **check(case, dist.group.WORLD))
    finally:
        dist.destroy_process_group()


def _spawn(case, tmp_path, check) -> list:
    """Run `check` on each of the case's P gloo ranks; every rank's saved
    arrays, checked bitwise equal across ranks."""
    ctx = mp.start_processes(_rank_main, args=(case, tmp_path, check),
                             nprocs=case[0], join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [np.load(pathlib.Path(tmp_path) / f"rank{q}.npz")
             for q in range(case[0])]
    for q in range(1, case[0]):
        for name in ranks[0].files:
            _bitwise(ranks[q][name], ranks[0][name], f"rank {q} {name}")
    return ranks


@pytest.mark.parametrize("case", CASES, ids=[f"P{c[0]}-K{c[1]}-r{c[2]}"
                                             for c in CASES])
def test_group_exchange_bitwise_on_every_rank(case, tmp_path):
    _hold_against_reference(case, _spawn(case, tmp_path, _check_rank))


@pytest.mark.parametrize("case", HIER_CASES, ids=[
    f"P{c[0]}-{c[1][0]}x{c[1][1]}" for c in HIER_CASES])
def test_two_level_group_exchange_bitwise_on_every_rank(case, tmp_path):
    ranks = _spawn(case, tmp_path, _check_hier_rank)
    _hold_hier_against_reference(case, ranks)


def _reference_graph(g):
    """The JAX package's `Graph` on the port's edges, its CSR checked
    equal."""
    from repro.core import graph_models as r_gm

    csr = g.csr
    upper = csr.rows < csr.indices
    rg = r_gm.Graph.from_edges(csr.rows[upper], csr.indices[upper], g.n)
    assert np.array_equal(rg.csr.indptr, csr.indptr)
    assert np.array_equal(rg.csr.indices, csr.indices)
    return rg


def _hold_hier_against_reference(case, ranks):
    """Every rank's words, per-level bits and min states against the JAX
    package's on the same graph and topology: the words bitwise its flat
    `execute_coded_sparse`, the bits its `compile_hierarchical`'s, sssp
    and multi_sssp bitwise its `reference_run`."""
    from repro.core import algorithms as r_algo
    from repro.core import allocation as r_allocation
    from repro.core.shuffle_plan import compile_hierarchical as r_compile_h
    from repro.launch.mesh import Topology as RTopology

    P, (R, S), r, n_base, seed = case
    g, _, _ = _hier_graph(case)
    rg = _reference_graph(g)
    ralloc = r_allocation.er_allocation(g.n, R * S, r)
    hp = r_compile_h(rg.csr, ralloc, RTopology(R, S))
    tables = hp.flat.edge_tables(rg.csr, ralloc)
    want = {f"words_b{B}": floats_to_words(
        hp.flat.execute_coded_sparse(vals, tables).values)
        for B, vals in zip((1, 4), _inputs(r_algo.pagerank(), rg, seed))}
    want["sssp"] = r_algo.reference_run(r_algo.sssp(0), rg, ITERS)
    want["multi_sssp"] = r_algo.reference_run(
        r_algo.multi_sssp(_roots(g.n)), rg, ITERS)
    for q, rank in enumerate(ranks):
        assert list(rank["rack_bits"]) == [hp.inter_rack_bits,
                                           hp.intra_rack_bits], f"rank {q}"
        for name, w in want.items():
            _bitwise(rank[name], w, f"rank {q} {name} against the reference")


def _hold_against_reference(case, ranks):
    """Every rank's words and states against the JAX package's on the same
    graph (the reference's `Graph` built from the port's edges): the words
    bitwise its `execute_coded_sparse`, sssp and multi_sssp bitwise its
    `reference_run`, pagerank within its sum contract, rtol 1e-5."""
    from repro.core import algorithms as r_algo
    from repro.core import allocation as r_allocation
    from repro.core.shuffle_plan import compile_plan_csr as r_compile

    P, K, r, n_base, seed = case
    _, g, _ = _case_graph(case)
    n = g.n
    rg = _reference_graph(g)
    ralloc = r_allocation.er_allocation(n, K, r)
    plan = r_compile(rg.csr, ralloc)
    tables = plan.edge_tables(rg.csr, ralloc)
    rprog = r_algo.pagerank()
    states = {"pagerank": rprog, "sssp": r_algo.sssp(0),
              "multi_sssp": r_algo.multi_sssp(_roots(n))}
    want = {f"words_b{B}": floats_to_words(
        plan.execute_coded_sparse(vals, tables).values)
        for B, vals in zip((1, 4), _inputs(rprog, rg, seed))}
    want.update({name: r_algo.reference_run(p, rg, ITERS)
                 for name, p in states.items()})
    for q, rank in enumerate(ranks):
        for name, w in want.items():
            if name == "pagerank":
                np.testing.assert_allclose(rank[name], w, rtol=1e-5, atol=0,
                                           err_msg=f"rank {q} pagerank")
            else:
                _bitwise(rank[name], w, f"rank {q} {name} against the reference")


def test_group_needs_an_initialised_process_group():
    import torch.distributed as dist

    from repro_torch.launch.dist import server_shard

    if dist.is_available() and dist.is_initialized():
        pytest.skip("a process group is initialised in this process")
    g = graphs.erdos_renyi(48, 0.2, seed=1)
    alloc = er_allocation(48, 4, 2)
    with pytest.raises(ValueError, match="init_process_group"):
        server_shard(object(), 4)
    with pytest.raises(ValueError, match="init_process_group"):
        _session(g, alloc, None, algo.pagerank(), object())
