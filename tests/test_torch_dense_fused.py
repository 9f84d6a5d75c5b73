"""The port's dense validation exchange against the reference (on the CPU).

* `build_schedule`'s four arrays equal the reference's, on ER (r = 1, 2,
  3), power-law, SBM and RB graphs at K = 6.
* `run_fused` (`device="cpu"`: K1's general form runs its plain version)
  is bitwise the reference's `run_fused` on a 6-device host mesh
  (`repro.launch.mesh.make_servers_mesh(6)`, one jax subprocess) on
  `REFERENCE_DENSE` (r = 3, power-law and RB: its shard_map takes about
  11 s to compile a case), and `run_fused_sparse`'s delivered words are
  bitwise the reference's `run_fused_sparse` there on every case. The Map
  output is random float32 bits on the edges (NaN payloads and -0
  included).
* Without JAX: `run_fused` holds `values[i, j]` at every
  `missing_pairs(adj, alloc, k)` entry and 0 elsewhere.
* The group form on gloo at world 2 and 3 (K = 6), spawned here, is
  bitwise the virtual route on every rank.
* n * n past int32 is refused (by `fused_exchange`, before it reads the
  values or builds a table on the device).
* `floats_as_words` / `words_as_floats` are the reference's raw bitcasts.
* No fallback: the default device is the card, which raises without one.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.core import graph_models as r_gm
from repro.core.allocation import bipartite_allocation as r_bipartite
from repro.core.allocation import er_allocation as r_er
from repro.core.fused_shuffle import build_schedule as r_build_schedule
from repro.kernels.xor_code import ops as r_ops
from repro_torch.core import graph_models as t_gm
from repro_torch.core.allocation import (bipartite_allocation, divisible_n,
                                         er_allocation)
from repro_torch.core.fused_shuffle import (DENSE_MAX_N, build_schedule,
                                            fused_exchange, run_fused,
                                            run_fused_sparse)
from repro_torch.core.uncoded_shuffle import missing_pairs
from repro_torch.kernels import _build
from repro_torch.kernels.xor_code.ops import floats_as_words, words_as_floats

K = 6
TIMEOUT_S = 120
# name: (model, sampler kwargs, allocation (name, args), seed)
CASES = {
    "er-r1": ("er", dict(n=divisible_n(60, K, 1), p=0.25), ("er", 1), 5),
    "er-r2": ("er", dict(n=divisible_n(60, K, 2), p=0.25), ("er", 2), 5),
    "er-r3": ("er", dict(n=divisible_n(60, K, 3), p=0.3), ("er", 3), 2),
    "pl": ("pl", dict(n=divisible_n(90, K, 2), gamma=2.5, d_min=3.0),
           ("er-interleave", 2), 7),
    "sbm": ("sbm", dict(n1=45, n2=45, p=0.3, q=0.1), ("er-interleave", 2), 3),
    "rb": ("rb", dict(n1=36, n2=36, q=0.3), ("bipartite", 2), 4),
}
REFERENCE_DENSE = ("er-r3", "pl", "rb")

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=6"
import json
import numpy as np

from repro.core import graph_models as gm
from repro.core.allocation import bipartite_allocation, er_allocation
from repro.core.fused_shuffle import run_fused, run_fused_sparse
from repro.launch.mesh import make_servers_mesh

sys.path.insert(0, "tests")
from test_torch_dense_fused import CASES, K, REFERENCE_DENSE, case_values

out = sys.argv[1]
mesh = make_servers_mesh(K)
arrays = {}
for name, (model, kw, (how, r), seed) in CASES.items():
    g = gm.sample(model, seed=seed, **kw)
    alloc = (bipartite_allocation(kw["n1"], kw["n2"], K, r)
             if how == "bipartite"
             else er_allocation(g.n, K, r, interleave=how == "er-interleave"))
    values = case_values(g.adj, seed)
    if name in REFERENCE_DENSE:
        arrays[name + "/dense"] = np.asarray(run_fused(g, values, alloc, mesh))
    ev = values[g.csr.rows, g.csr.indices]
    res = run_fused_sparse(g, ev, alloc, mesh)
    arrays[name + "/sparse"] = np.asarray(res.values, np.float32)
np.savez(out, **arrays)
print(json.dumps({"cases": len(CASES)}))
"""


def case_values(adj: np.ndarray, seed: int) -> np.ndarray:
    """The Map output [n, n] float32: random bits on the edges (NaN
    payloads, infinities and -0 among them), 0 elsewhere."""
    rng = np.random.default_rng(1000 + seed)
    bits = rng.integers(0, 2 ** 32, size=adj.shape, dtype=np.uint32)
    bits[0, :4] = (0x80000000, 0x7FC00001, 0xFF800000, 0x7F800000)
    return np.where(adj, bits, 0).astype(np.uint32).view(np.float32)


def _graph(model, kw, seed):
    return t_gm.sample(model, seed=seed, **kw)


def _alloc(g, kw, how, r):
    if how == "bipartite":
        return bipartite_allocation(kw["n1"], kw["n2"], K, r)
    return er_allocation(g.n, K, r, interleave=how == "er-interleave")


def _port_case(name):
    model, kw, (how, r), seed = CASES[name]
    g = _graph(model, kw, seed)
    return g, _alloc(g, kw, how, r), case_values(g.adj, seed)


def _bitwise(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                  err_msg=what)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's `run_fused` (on `REFERENCE_DENSE`) and
    `run_fused_sparse` (on every case), in one subprocess with 6 forced
    host devices."""
    out = tmp_path_factory.mktemp("dense-ref") / "ref.npz"
    home = os.environ.get("HOME") or str(tmp_path_factory.mktemp("home"))
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin", "HOME": home,
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(out)],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "cases": len(CASES)}
    return np.load(out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_schedule_is_the_references(name):
    model, kw, (how, r), seed = CASES[name]
    g, alloc, _ = _port_case(name)
    rg = r_gm.sample(model, seed=seed, **kw)
    ralloc = (r_bipartite(kw["n1"], kw["n2"], K, r) if how == "bipartite"
              else r_er(rg.n, K, r, interleave=how == "er-interleave"))
    got, want = build_schedule(g, alloc), r_build_schedule(rg, ralloc)
    for a, b, what in zip(got, want, ("enc_idx", "dec_src", "dec_tgt",
                                      "dec_strip")):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("name", REFERENCE_DENSE)
def test_run_fused_is_the_references_on_6_devices(name, reference):
    g, alloc, values = _port_case(name)
    _build.LAUNCHES.clear()
    got = run_fused(g, values, alloc, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert _build.LAUNCHES.get("xor_encode_gather", 0) == 0   # plain version
    _bitwise(got.numpy(), reference[name + "/dense"], f"{name} run_fused")


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_fused_sparse_is_the_references_on_6_devices(name, reference):
    g, alloc, values = _port_case(name)
    ev = values[g.csr.rows, g.csr.indices]
    res = run_fused_sparse(g, ev, alloc, device="cpu")
    _bitwise(res.values, reference[name + "/sparse"],
             f"{name} run_fused_sparse")


def _oracle(g, alloc, values):
    want = np.zeros_like(values)
    total = 0
    for k in range(alloc.K):
        mp = missing_pairs(g.adj, alloc, k)
        total += len(mp)
        if len(mp):
            want[mp[:, 0], mp[:, 1]] = values[mp[:, 0], mp[:, 1]]
    return want, total


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_fused_delivers_every_missing_pair(name):
    g, alloc, values = _port_case(name)
    want, total = _oracle(g, alloc, values)
    assert total > 100
    _bitwise(run_fused(g, values, alloc, device="cpu").numpy(), want, name)


def test_fused_exchange_takes_one_schedule_many_times():
    """The schedule is data-independent: one `build_schedule`, two Map
    outputs, each delivered exactly; a float64 input is cast to float32
    first, as the reference casts it."""
    g, alloc, values = _port_case("er-r2")
    sched = build_schedule(g, alloc)
    for v in (values, np.where(g.adj, 0.25, 0.0)):
        want, _ = _oracle(g, alloc, v.astype(np.float32))
        _bitwise(fused_exchange(v, *sched, device="cpu").numpy(), want, "again")


def _rank_main(rank, world, tmp):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"),
                                                         world),
                            rank=rank, world_size=world)
    try:
        out = {}
        for name in ("er-r2", "er-r3", "rb"):
            g, alloc, values = _port_case(name)
            out[name] = run_fused(g, values, alloc, device="cpu",
                                  group=dist.group.WORLD).numpy()
        np.savez(tmp / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 3])
def test_group_form_on_gloo_is_the_virtual_route(world, tmp_path):
    ctx = mp.start_processes(_rank_main, args=(world, tmp_path), nprocs=world,
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
    for name in ("er-r2", "er-r3", "rb"):
        g, alloc, values = _port_case(name)
        want = run_fused(g, values, alloc, device="cpu").numpy()
        for q in range(world):
            got = np.load(pathlib.Path(tmp_path) / f"rank{q}.npz")[name]
            _bitwise(got, want, f"{name} rank {q} of {world}")


def test_dense_exchange_refuses_n_past_int32():
    n = divisible_n(DENSE_MAX_N + 1, K, 2)
    assert n * n >= 2 ** 31 > DENSE_MAX_N ** 2
    values = torch.zeros(1, 1).expand(n, n)           # no [n, n] memory
    empty = np.zeros((K, 0, 2, 2), np.int32)
    with pytest.raises(ValueError, match="int32"):
        fused_exchange(values, empty, np.zeros((K, 0, 2), np.int32),
                       np.zeros((K, 0, 2), np.int32),
                       np.zeros((K, 0, 1, 2), np.int32), device="cpu")
    g = t_gm.Graph.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), n)
    with pytest.raises(ValueError, match="int32"):
        run_fused(g, values, er_allocation(n, K, 2), device="cpu")


def test_fused_exchange_refuses_a_non_square_input():
    g, alloc, values = _port_case("er-r2")
    with pytest.raises(ValueError, match=r"\[n, n\]"):
        fused_exchange(values[:, :-1], *build_schedule(g, alloc), device="cpu")


def test_no_fallback_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    g, alloc, values = _port_case("er-r2")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fused(g, values, alloc)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fused_sparse(g, values[g.csr.rows, g.csr.indices], alloc)


def test_bitcasts_are_the_references():
    bits = np.array([0, 0x80000000, 0x7FC00000, 0x7FC00001, 0xFFBADBAD,
                     0x7F800000, 0xFF800000, 0x00000001, 0x3F800000,
                     0xDEADBEEF], dtype=np.uint32)
    bits = np.concatenate([bits, np.random.default_rng(0).integers(
        0, 2 ** 32, size=118, dtype=np.uint32)])
    floats = bits.view(np.float32)
    want = np.asarray(r_ops.floats_as_words(jnp.asarray(floats)))
    got = floats_as_words(torch.from_numpy(floats.copy()))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(want, bits)
    back = np.asarray(r_ops.words_as_floats(jnp.asarray(bits)))
    for w in (got, torch.from_numpy(bits.copy())):
        f = words_as_floats(w)
        assert f.dtype == torch.float32
        np.testing.assert_array_equal(f.numpy().view(np.uint32),
                                      back.view(np.uint32))
    np.testing.assert_array_equal(back.view(np.uint32), bits)
    with pytest.raises(ValueError, match="int32 or uint32"):
        words_as_floats(torch.zeros(3))
