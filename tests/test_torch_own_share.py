"""A session on a process group Maps and Reduces only each rank's share
(`engine.compile(..., backend="fused", group=)`), on gloo, CPU ranks
spawned here.

Each case spawns P ranks of one `torch.distributed` group (a `FileStore`
in a temporary directory, so no port is opened) running K servers, K / P
per rank, on an Erdos-Renyi or a power-law graph of a few thousand
vertices. On every rank:

* the rank's share (`launch/dist.own_share`) is what its servers Map and
  Reduce, and the session's Map reads only those entries;
* a PageRank job from a seeded start is bitwise the single-process fused
  session's, and the route gathers no delivered word (no `phase.gather`
  span);
* over the job the registry's `exchange_wire_bits` grows by what the
  all-gathers of the coded buffers bring the rank (the other ranks' K - K
  / P buffers of W + 1 words an iteration), `state_wire_bits` by the
  other ranks' reduced rows (P - 1 parts of `pad` rows), and
  `exchange_rounds` by one an iteration;
* the registry's gauges hold the rank's share: the rows and CSR entries
  its K3 reduces, the deliveries its servers receive, those of them
  coded, and the coded bits its servers send.

This process then holds every rank's state against a plain float64
PageRank written here (within 1e-5 relative) and against the others
bitwise, and the ranks' gauges summed against the whole graph's rows
and entries and the plan's M, P and coded bits. A session whose ranks skip the all-gather of the reduced rows
fails that comparison.
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
from repro_torch.launch.dist import ServerShard, own_share
from repro_torch.obs import get_registry, get_tracer

TIMEOUT_S = 120
ITERS = 6
DAMPING = 0.15
# (graph, world P, servers K, r)
CASES = [("er", 2, 4, 2), ("er", 4, 4, 2), ("er", 4, 8, 3),
         ("pl", 2, 4, 2), ("pl", 4, 4, 2), ("pl", 4, 8, 3)]
COUNTERS = ("exchange_wire_bits", "state_wire_bits", "exchange_rounds")
GAUGES = ("reduce_rows", "reduce_entries", "shuffle_rank_deliveries",
          "shuffle_rank_coded_deliveries", "shuffle_rank_coded_bits")


def _graph(case):
    """(graph padded for K and r, allocation) of a case."""
    model, _, K, r = case
    g = (graphs.erdos_renyi(2400, 8.0 / 2399, seed=11) if model == "er"
         else graphs.power_law(2400, 2.5, seed=13, d_min=3.0))
    n = divisible_n(g.n, K, r)
    return g.padded(n), er_allocation(n, K, r, interleave=True)


def _start(n: int) -> np.ndarray:
    x = np.random.default_rng(5).random(n) + 0.5
    return (x / x.sum()).astype(np.float32)


def _session(g, alloc, group=None):
    return engine.compile(algo.pagerank(DAMPING), g, alloc, "coded",
                          path="sparse", backend="fused", device="cpu",
                          group=group)


def _skip_state_gather(eng):
    """The session with its ranks' all-gather of the reduced rows left
    out: each rank places only its own rows, zeros elsewhere."""
    fx, rows = eng.fused, torch.from_numpy(eng.fused.share.rows)

    def own_rows_only(part):
        out = part.new_zeros((eng.g.n,) + tuple(part.shape[1:]))
        out[rows] = part
        return out

    fx.gather_rows = own_rows_only
    return eng


def _check_rank(case, group, skip: bool) -> dict:
    import torch.distributed as dist

    g, alloc = _graph(case)
    eng = _session(g, alloc, group)
    fx, sh = eng.fused, eng.fused.share
    P = dist.get_world_size(group)
    servers = fx.shard.servers
    mapped = alloc.map_sets[servers.start:servers.stop].any(axis=0)
    assert np.array_equal(sh.map_e, np.flatnonzero(mapped[g.csr.indices]))
    assert np.array_equal(sh.rows, np.flatnonzero(
        np.isin(alloc.reduce_owner, list(servers))))
    assert torch.equal(eng._dg.indices,
                       torch.from_numpy(g.csr.indices[sh.map_e].astype(np.int64)))
    if skip:
        _skip_state_gather(eng)

    reg, tr = get_registry(), get_tracer()
    before = [reg.counter(c, "").value for c in COUNTERS]
    tr.reset().enable()
    try:
        state = eng.run(ITERS, state=_start(g.n)).state.numpy()
    finally:
        tr.disable()
    grown = [reg.counter(c, "").value - b for c, b in zip(COUNTERS, before)]
    names = {s.name for s in tr.spans()}
    tr.reset()
    assert "phase.gather" not in names and "phase.exchange" in names
    words = fx.sched.W + 1
    wire = (P - 1) * len(servers) * words * 32 * ITERS
    rows = 0 if skip else (P - 1) * sh.pad * 32 * ITERS
    assert grown == [wire, rows, ITERS], (grown, wire, rows)
    return {"state": state,
            "gauges": np.array([reg.get(name).value for name in GAUGES],
                               dtype=np.int64)}


def _rank_main(rank, case, tmp, skip):
    import torch.distributed as dist

    torch.set_num_threads(1)
    world = case[1]
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world),
                            rank=rank, world_size=world)
    try:
        np.savez(tmp / f"rank{rank}.npz",
                 **_check_rank(case, dist.group.WORLD, skip))
    finally:
        dist.destroy_process_group()


def _spawn(case, tmp_path, skip=False) -> list:
    """Every rank's saved arrays, after `_check_rank` on each of the
    case's P gloo ranks."""
    ctx = mp.start_processes(_rank_main, args=(case, tmp_path, skip),
                             nprocs=case[1], join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [np.load(pathlib.Path(tmp_path) / f"rank{q}.npz")
            for q in range(case[1])]


def plain_pagerank(indptr, indices, x0, iters, damping) -> np.ndarray:
    """PageRank in float64 with plain torch: x' = (1 - d) A (x / deg) + d / n."""
    n = indptr.size - 1
    deg = torch.from_numpy(np.maximum(np.diff(indptr), 1)).double()
    rows = torch.from_numpy(np.repeat(np.arange(n), np.diff(indptr)))
    cols = torch.from_numpy(indices.astype(np.int64))
    x = torch.from_numpy(x0).double()
    for _ in range(iters):
        acc = torch.zeros(n, dtype=torch.float64).index_add_(
            0, rows, (x / deg)[cols])
        x = (1.0 - damping) * acc + damping / n
    return x.numpy()


def _max_rel_err(got, want) -> float:
    return float(np.max(np.abs(got.astype(np.float64) - want) / want))


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-P{c[1]}-K{c[2]}-r{c[3]}"
                                             for c in CASES])
def test_each_rank_maps_and_reduces_its_share(case, tmp_path):
    ranks = _spawn(case, tmp_path)
    g, alloc = _graph(case)
    ses = _session(g, alloc)
    single = ses.run(ITERS, state=_start(g.n)).state.numpy()
    want = plain_pagerank(g.csr.indptr, g.csr.indices, _start(g.n), ITERS,
                          DAMPING)
    assert _max_rel_err(single, want) <= 1e-5
    assert sum(rank["gauges"] for rank in ranks).tolist() == [
        g.n, g.csr.nnz, ses.plan.all_k.size, ses.plan.pair_k.size,
        ses.plan.coded_bits]
    for q, rank in enumerate(ranks):
        got = rank["state"]
        assert got.view(np.uint32).tolist() == single.view(np.uint32).tolist(), \
            f"rank {q} differs from the single-process session"
        assert _max_rel_err(got, want) <= 1e-5, f"rank {q}"


def test_skipping_the_state_gather_fails_the_comparison(tmp_path):
    case = ("er", 2, 4, 2)
    ranks = _spawn(case, tmp_path, skip=True)
    g, _ = _graph(case)
    want = plain_pagerank(g.csr.indptr, g.csr.indices, _start(g.n), ITERS,
                          DAMPING)
    for rank in ranks:
        err = _max_rel_err(rank["state"], want)
        assert not err <= 1e-5, err          # NaN fails too, as in the harness


def test_own_share_partitions_rows_and_reads_back_vertex_order():
    """Every vertex is Reduced by one rank; `order` puts the gathered,
    padded parts back in vertex order; a rank's Map entries are those of
    its servers' Map sets."""
    n, K = 36, 4
    alloc = er_allocation(n, K, 2, interleave=True)
    alloc.reduce_owner[:4] = 0                  # uneven: rank 0 holds more
    indices = np.random.default_rng(3).integers(0, n, 200)
    for P in (1, 2, 4):
        shares = [own_share(ServerShard(None, P, q, K), alloc.map_sets,
                            alloc.reduce_owner, indices) for q in range(P)]
        rows = np.concatenate([s.rows for s in shares])
        assert np.array_equal(np.sort(rows), np.arange(n))
        pad = shares[0].pad
        assert pad == max(s.rows.size for s in shares)
        gathered = np.full(P * pad, -1)
        for q, s in enumerate(shares):
            gathered[q * pad:q * pad + s.rows.size] = s.rows
        for s in shares:
            assert np.array_equal(gathered[s.order], np.arange(n))
        for q, s in enumerate(shares):
            ks = range(q * K // P, (q + 1) * K // P)
            want = np.flatnonzero(alloc.map_sets[list(ks)].any(axis=0)[indices])
            assert np.array_equal(s.map_e, want)
