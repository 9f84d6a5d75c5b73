"""A run of each cell on the CPU at a tiny size, the look for a card
skipped: the result line's keys, `correct` true on the sound program and
false under each fault a cell can have, and the control failing the same
limit. Then `run.py` itself, which has to fail where there is no card."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpubench_tiny import BENCH, ROOT, run_tiny, spec, tiny_tree
from harness import cell, graph, manifest
from repro_torch.core import engine
from repro_torch.core.device_plan import DevicePlan
from repro_torch.core.fused_shuffle import FusedSparseShuffle
from repro_torch.serve.service import GraphService

CELLS = ["pl-1m.pagerank", "er-1m.pagerank", "pl-1m.ppr-serve"]
JOBS = CELLS[:2]
SERVE = CELLS[2]
HEAD = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(root, workload, trace):
    res = run_tiny(root, workload, trace=trace)
    keys = list(res)
    assert keys[:5] == HEAD and keys[-1] == "checks"
    assert set(keys) <= set(HEAD) | {"breakdown", "checks"}
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    cell = spec(root, workload)
    want = cell.per_layer if trace else cell.end_to_end
    got = set(res["metrics"])
    # On the CPU nothing reads the device: no peak, no profile.
    device_only = {"peak_mem_mb", "xor_code_roofline",
                   "segment_reduce_roofline", "device_idle_pct.job",
                   "device_idle_pct.serve"}
    assert got == {m["name"] for m in want} - device_only
    for m in want:
        if m["name"] in got:
            assert res["metrics"][m["name"]]["unit"] == m["unit"]
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    sys.path.insert(0, str(BENCH))
    import run as run_py
    json.loads(json.dumps(run_py.finite(res), allow_nan=False))


def _zero_exchange(monkeypatch):
    fused, words = FusedSparseShuffle.exchange, DevicePlan.words
    monkeypatch.setattr(FusedSparseShuffle, "exchange",
                        lambda self, *a, **k: torch.zeros_like(
                            fused(self, *a, **k)))
    monkeypatch.setattr(DevicePlan, "words",
                        lambda self, *a, **k: torch.zeros_like(
                            words(self, *a, **k)))


def _unchanged_step(monkeypatch):
    monkeypatch.setattr(engine.CompiledEngine, "_step",
                        lambda self, state: (state, self._bits))


def _altered_answer(monkeypatch):
    """One value of each result, its largest, 1% off: ten times the limit
    of either mix, where the program's own rounding reads a tenth of it."""
    run = engine.CompiledEngine.run

    def altered(self, *a, **k):
        res = run(self, *a, **k)
        flat = res.state.view(-1)
        flat[flat.abs().argmax()] *= 1.01
        return res
    monkeypatch.setattr(engine.CompiledEngine, "run", altered)


WIDEST = []


def _half_batch(monkeypatch):
    execute = GraphService._execute

    def half(self, kind, args, iters):
        WIDEST.append(len(args))
        keep = max(1, len(args) // 2)
        res = execute(self, kind, args[:keep], iters)
        mean = res.state.mean(dim=1, keepdim=True)
        res.state = torch.cat([res.state, mean.expand(-1, len(args) - keep)],
                              dim=1)
        return res
    monkeypatch.setattr(GraphService, "_execute", half)


FAULTS = {"unchanged_step": (_unchanged_step, CELLS),
          "exchange_left_out": (_zero_exchange, CELLS),
          "answer_altered": (_altered_answer, CELLS),
          "half_batch": (_half_batch, [SERVE])}


@pytest.mark.parametrize("fault,workload",
                         [(f, w) for f, (_, ws) in FAULTS.items() for w in ws])
def test_fault_makes_the_run_incorrect(root, monkeypatch, fault, workload):
    FAULTS[fault][0](monkeypatch)
    WIDEST.clear()
    res = run_tiny(root, workload, seed=2**31 + 77)
    assert res["correct"] is False
    if fault == "half_batch":
        assert max(WIDEST) >= 2         # some batch had a half to leave out


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limit(workload):
    """The reference in the control's precision (float32 state, bfloat16
    messages) in the program's place, at n = 30,000, judged by the run's
    own comparison: `correct` false on every seed, its number above three
    times the mix's limit, where the program on the CPU stays below it
    (`test_result_line`)."""
    spec = manifest.resolve(manifest.load_manifest(ROOT), workload)
    ref = manifest.load(BENCH, "reference", spec.config["reference"])
    driver = manifest.load(BENCH, "drivers", spec.traffic["driver"])
    params = dict(spec.config["graph"], n=30_000)
    u, v, n = manifest.load(BENCH, "graphs", params["sampler"]).edges(params)
    csr = graph.csr_of(u, v, n)
    for seed in (1, 2, 2**31 + 3):
        ctx = cell.RunContext(spec, csr, seed, torch.device("cpu"))
        outputs = driver.control_outputs(ctx, ref)
        checks, _, correct = cell.verdict(driver, ctx, outputs, ref, 0)
        err, limit = checks["max_rel_err"]
        assert correct is False
        assert err > 3 * limit


def test_max_rel_err():
    from harness import manifest as m
    ref = m.load(BENCH, "reference", "pagerank")
    want = np.array([1.0, 0.0, 2.0])
    assert ref.max_rel_err(want.copy(), want) == 0.0
    assert ref.max_rel_err(np.array([1.0, 1e-30, 2.0]), want) > 1e6
    assert ref.max_rel_err(np.array([1.0, 0.0, 2.002]), want) == pytest.approx(1e-3)
    assert ref.max_rel_err(np.array([np.nan, 0.0, 2.0]), want) == float("inf")
    assert ref.max_rel_err(np.zeros(2), want) == float("inf")


def test_run_py_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr
