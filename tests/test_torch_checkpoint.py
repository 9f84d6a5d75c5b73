"""Port session checkpoints (`core/checkpoint.py`, `run(checkpoint=,
start_iter=, start_bits=)`, `engine.restore`) vs the reference package, on
the CPU.

* checkpoint -> kill -> restore resumes bitwise the uninterrupted run, onto
  the same K and elastically onto K' != K, for pagerank and sssp; the
  resumed state agrees with the reference's uninterrupted run (sssp
  bitwise, pagerank within rtol 1e-5) and the bits are exact.
* Atomicity: a crash at any step of a save (array write, manifest write,
  publish) leaves the newest published epoch readable and the failure
  surfaces at the next `wait`; directories without a manifest are
  invisible; retention keeps the newest `keep`; corruption is detected.
* The same on-disk format: a checkpoint written by the reference is
  restored and resumed by the port, and one written by the port by the
  reference; the allocation fingerprints agree.
* `save` snapshots a tensor state on the caller's thread: changing the
  tensor right after cannot reach the file.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import algorithms as r_algo
from repro.core import engine as r_engine
from repro.core import graph_models as r_gm
from repro.core.allocation import divisible_n, er_allocation
from repro.core.checkpoint import SessionCheckpointer as RCheckpointer
from repro.core.checkpoint import alloc_fingerprint as r_fingerprint
from repro.core.checkpoint import load_checkpoint as r_load
from repro_torch.core import algorithms as t_algo
from repro_torch.core import convert
from repro_torch.core import engine as t_engine
from repro_torch.core import faults as t_faults
from repro_torch.core.checkpoint import (SessionCheckpointer,
                                         alloc_fingerprint, load_checkpoint)

SUM_TOL = dict(rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def setup():
    K, r = 5, 2
    n = divisible_n(60, K, r)
    g = r_gm.erdos_renyi(n, 0.2, seed=3)
    alloc = er_allocation(n, K, r)
    csr = g.csr
    tg = convert.graph(csr.indptr, csr.indices, csr.rows, g.edge_weights())
    ta = convert.allocation({f.name: getattr(alloc, f.name)
                             for f in dataclasses.fields(alloc)})
    return g, alloc, tg, ta


def _programs(name):
    if name == "pagerank":
        return r_algo.pagerank(), t_algo.pagerank()
    return r_algo.sssp(0), t_algo.sssp(0)


def _check_state(got, want, name):
    got = got.cpu().numpy()
    if name == "pagerank":
        np.testing.assert_allclose(got, want, **SUM_TOL)
    else:
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("prog_name", ["pagerank", "sssp"])
@pytest.mark.parametrize("backend", ["numpy", "fused"])
def test_kill_restore_same_K_is_bitwise(setup, tmp_path, prog_name, backend):
    g, alloc, tg, ta = setup
    rprog, tprog = _programs(prog_name)
    opts = dict(path="sparse", backend=backend, device="cpu")
    full = t_engine.compile(tprog, tg, ta, "coded", **opts).run(8)
    ck = SessionCheckpointer(str(tmp_path), keep=3)
    t_engine.compile(tprog, tg, ta, "coded", **opts).run(
        5, checkpoint=ck, checkpoint_every=2)
    ck.wait()
    assert ck.epochs() == [2, 4, 5]
    eng, ckpt = t_engine.restore(str(tmp_path), tprog, tg, **opts)
    assert ckpt.iteration == 5
    assert ckpt.fingerprint == alloc_fingerprint(ta) == r_fingerprint(alloc)
    res = eng.run(3, state=ckpt.state, start_iter=ckpt.iteration,
                  start_bits=ckpt.shuffle_bits)
    assert torch.equal(res.state, full.state)
    assert res.shuffle_bits == full.shuffle_bits
    assert res.iters == full.iters == 8
    want = r_engine.compile(rprog, g, alloc, "coded").run(8)
    _check_state(res.state, want.state, prog_name)
    assert res.shuffle_bits == want.shuffle_bits


@pytest.mark.parametrize("prog_name", ["pagerank", "sssp"])
def test_elastic_restore_onto_different_K_is_bitwise(setup, tmp_path,
                                                     prog_name):
    g, alloc, tg, ta = setup
    rprog, tprog = _programs(prog_name)
    full = t_engine.compile(tprog, tg, ta, "coded", device="cpu").run(8)
    ck = SessionCheckpointer(str(tmp_path))
    t_engine.compile(tprog, tg, ta, "coded", device="cpu").run(
        4, checkpoint=ck, checkpoint_every=4)
    ck.wait()
    for K_new in (2, 4, 6):             # n = 60 divides all of these at r = 2
        eng, ckpt = t_engine.restore(str(tmp_path), tprog, tg, K=K_new,
                                     device="cpu")
        assert eng.alloc.K == K_new
        res = eng.run(4, state=ckpt.state, start_iter=ckpt.iteration,
                      start_bits=ckpt.shuffle_bits)
        assert torch.equal(res.state, full.state), K_new
        reng, rck = r_engine.restore(str(tmp_path), rprog, g, K=K_new)
        want = reng.run(4, state=rck.state, start_iter=rck.iteration,
                        start_bits=rck.shuffle_bits)
        assert res.shuffle_bits == want.shuffle_bits, K_new
        _check_state(res.state, want.state, prog_name)


def test_crash_mid_save_never_corrupts_latest(setup, tmp_path, monkeypatch):
    _, _, _, ta = setup
    ck = SessionCheckpointer(str(tmp_path), keep=5)
    ck.save(1, np.ones(4, np.float32), 100, ta, blocking=True)
    good = load_checkpoint(str(tmp_path))
    real_save, real_dump, real_replace = np.save, json.dump, os.replace
    for fail in ("array", "manifest", "publish"):
        def boom(*a, **k):
            raise OSError(f"disk died during {fail}")
        if fail == "array":
            monkeypatch.setattr(np, "save", boom)
        elif fail == "manifest":
            monkeypatch.setattr(json, "dump", boom)
        else:
            monkeypatch.setattr(os, "replace", boom)
        ck.save(2, torch.zeros(4), 200, ta)
        with pytest.raises(OSError, match="disk died"):
            ck.wait()                    # background failure surfaces here
        monkeypatch.setattr(np, "save", real_save)
        monkeypatch.setattr(json, "dump", real_dump)
        monkeypatch.setattr(os, "replace", real_replace)
        assert ck.epochs() == [1]
        again = load_checkpoint(str(tmp_path))
        assert again.iteration == good.iteration
        assert np.array_equal(again.state, good.state)
    ck.save(2, torch.zeros(4), 200, ta, blocking=True)
    assert ck.epochs() == [1, 2]


def test_failed_save_reraises_on_the_next_save(setup, tmp_path, monkeypatch):
    _, _, _, ta = setup
    ck = SessionCheckpointer(str(tmp_path))

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(json, "dump", boom)
    ck.save(1, np.ones(3, np.float32), 1, ta)
    ck._thread.join()
    monkeypatch.undo()
    with pytest.raises(OSError, match="disk full"):
        ck.save(2, np.ones(3, np.float32), 2, ta)
    ck.save(2, np.ones(3, np.float32), 2, ta, blocking=True)
    assert ck.epochs() == [2]


def test_manifest_last_partial_dirs_are_invisible(tmp_path):
    ck = SessionCheckpointer(str(tmp_path))
    ck.save(3, np.arange(4, dtype=np.float32), 7, None, blocking=True)
    os.makedirs(tmp_path / "epoch_9")
    np.save(tmp_path / "epoch_9" / "state.npy", np.zeros(4))
    os.makedirs(tmp_path / ".tmp_epoch_11")
    assert ck.epochs() == [3]
    assert load_checkpoint(str(tmp_path)).iteration == 3
    assert r_load(str(tmp_path)).iteration == 3


def test_retention_keeps_newest_n(tmp_path):
    ck = SessionCheckpointer(str(tmp_path), keep=2)
    for it in range(1, 6):
        ck.save(it, torch.full((3,), float(it)), it * 10, None, blocking=True)
    assert ck.epochs() == [4, 5]
    assert ck.latest() == 5
    assert load_checkpoint(str(tmp_path), epoch=4).shuffle_bits == 40
    with pytest.raises(FileNotFoundError, match="epoch 1"):
        load_checkpoint(str(tmp_path), epoch=1)


def test_corruption_is_detected(setup, tmp_path):
    _, _, _, ta = setup
    ck = SessionCheckpointer(str(tmp_path))
    ck.save(1, np.ones(8, np.float32), 1, ta, blocking=True)
    p = tmp_path / "epoch_1" / "state.npy"
    arr = np.load(p)
    arr[0] = -1.0
    np.save(p, arr)
    with pytest.raises(ValueError, match="digest mismatch"):
        load_checkpoint(str(tmp_path))


def test_restore_validation(setup, tmp_path):
    _, _, tg, ta = setup
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        t_engine.restore(str(tmp_path), t_algo.pagerank(), tg, device="cpu")
    ck = SessionCheckpointer(str(tmp_path))
    ck.save(1, np.ones(7, np.float32), 1, ta, blocking=True)
    with pytest.raises(ValueError, match="n="):
        t_engine.restore(str(tmp_path), t_algo.pagerank(), tg, device="cpu")


def test_checkpoint_through_failure_epoch(setup, tmp_path):
    """Checkpoints taken while degraded record the degraded allocation, so
    a restore resumes on the post-failure membership."""
    g, alloc, tg, ta = setup
    sched = t_faults.FaultSchedule([(1, "crash", (2,))])
    ck = SessionCheckpointer(str(tmp_path))
    res = t_engine.compile(t_algo.sssp(0), tg, ta, "coded", device="cpu").run(
        4, checkpoint=ck, checkpoint_every=1, fault_schedule=sched)
    ck.wait()
    eng, ckpt = t_engine.restore(str(tmp_path), t_algo.sssp(0), tg,
                                 device="cpu")
    assert not ckpt.alloc.map_sets[2].any()
    assert np.array_equal(ckpt.state, res.state.numpy())
    more = eng.run(2, state=ckpt.state, start_iter=ckpt.iteration)
    assert np.array_equal(more.state.numpy(),
                          r_algo.reference_run(r_algo.sssp(0), g, 6))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_packages(setup, tmp_path, writer):
    """Either package restores the other's checkpoint and resumes it
    bitwise (sssp), with the same iteration, bits and fingerprint."""
    g, alloc, tg, ta = setup
    if writer == "reference":
        ck = RCheckpointer(str(tmp_path))
        r_engine.compile(r_algo.sssp(0), g, alloc, "coded").run(
            5, checkpoint=ck, checkpoint_every=5)
    else:
        ck = SessionCheckpointer(str(tmp_path))
        t_engine.compile(t_algo.sssp(0), tg, ta, "coded", device="cpu").run(
            5, checkpoint=ck, checkpoint_every=5)
    ck.wait()
    teng, tck = t_engine.restore(str(tmp_path), t_algo.sssp(0), tg,
                                 device="cpu")
    reng, rck = r_engine.restore(str(tmp_path), r_algo.sssp(0), g)
    assert (tck.iteration, tck.shuffle_bits, tck.fingerprint) == (
        rck.iteration, rck.shuffle_bits, rck.fingerprint) == (
        5, tck.shuffle_bits, r_fingerprint(alloc))
    assert np.array_equal(tck.state, rck.state)
    got = teng.run(3, state=tck.state, start_iter=5,
                   start_bits=tck.shuffle_bits)
    want = reng.run(3, state=rck.state, start_iter=5,
                    start_bits=rck.shuffle_bits)
    assert np.array_equal(got.state.numpy(), want.state)
    assert got.shuffle_bits == want.shuffle_bits
    assert np.array_equal(want.state,
                          r_algo.reference_run(r_algo.sssp(0), g, 8))


def test_save_snapshots_a_tensor_on_the_calling_thread(setup, tmp_path):
    _, _, _, ta = setup
    ck = SessionCheckpointer(str(tmp_path))
    state = torch.arange(ta.n, dtype=torch.float32)
    want = state.numpy().copy()
    ck.save(1, state, 3, ta)
    state.fill_(-7.0)                    # the next iteration overwrites it
    ck.wait()
    got = load_checkpoint(str(tmp_path))
    assert got.state.dtype == np.float32 and np.array_equal(got.state, want)
    assert got.alloc.K == ta.K and got.shuffle_bits == 3
