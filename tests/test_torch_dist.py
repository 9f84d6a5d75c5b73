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

The ranks' words and states are then compared with each other (the Map
and the Reduce run replicated, so every rank holds the same bits) and with
the JAX package's on the same graph: the words bitwise its
`execute_coded_sparse`, sssp and multi_sssp bitwise its `reference_run`,
pagerank within rtol 1e-5 of it. The world-2 case
also checks what raises: K % P != 0, a two-level topology with `group=`,
an unknown option.
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
    n = divisible_n(g0.n, 4, 2)
    g, alloc = g0.padded(n), er_allocation(n, 4, 2)
    with pytest.raises(NotImplementedError, match="Queue 1 #7b"):
        engine.compile(algo.pagerank(), g, alloc, "coded", path="sparse",
                       backend="fused", device="cpu", group=group,
                       topology=Topology(2, 2))
    hplan = compile_hierarchical(g.csr, alloc, Topology(2, 2))
    with pytest.raises(NotImplementedError, match="Queue 1 #7b"):
        FusedSparseShuffle(hplan, g.csr, alloc, device="cpu", group=group)
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


def _rank_main(rank, case, tmp):
    import torch.distributed as dist

    torch.set_num_threads(1)
    world = case[0]
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world),
                            rank=rank, world_size=world)
    try:
        np.savez(tmp / f"rank{rank}.npz", **_check_rank(case, dist.group.WORLD))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", CASES, ids=[f"P{c[0]}-K{c[1]}-r{c[2]}"
                                             for c in CASES])
def test_group_exchange_bitwise_on_every_rank(case, tmp_path):
    ctx = mp.start_processes(_rank_main, args=(case, tmp_path), nprocs=case[0],
                             join=False, start_method="spawn")
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
    _hold_against_reference(case, ranks)


def _hold_against_reference(case, ranks):
    """Every rank's words and states against the JAX package's on the same
    graph (the reference's `Graph` built from the port's edges): the words
    bitwise its `execute_coded_sparse`, sssp and multi_sssp bitwise its
    `reference_run`, pagerank within its sum contract, rtol 1e-5."""
    from repro.core import algorithms as r_algo
    from repro.core import allocation as r_allocation
    from repro.core import graph_models as r_gm
    from repro.core.shuffle_plan import compile_plan_csr as r_compile

    P, K, r, n_base, seed = case
    _, g, _ = _case_graph(case)
    csr, n = g.csr, g.n
    upper = csr.rows < csr.indices
    rg = r_gm.Graph.from_edges(csr.rows[upper], csr.indices[upper], n)
    assert np.array_equal(rg.csr.indptr, csr.indptr)
    assert np.array_equal(rg.csr.indices, csr.indices)
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
