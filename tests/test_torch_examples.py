"""The port's examples (`examples/port_*.py`) run on the CPU and print what
the reference's examples print (the LM examples: the same lines; their
weights and data are not JAX's bits, so not the same numbers).

Each example runs with `--device cpu` in a subprocess (with its own
timeout, `HOME` and `JAX_PLATFORMS=cpu`) and exits 0, having held its
states against the NumPy oracle itself; its printed load table, bits,
time model, best r and recovery counts equal those of the reference's
example (`examples/quickstart.py`, `examples/coded_pagerank.py`).
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROW = re.compile(r"^\s*\d+(\s+(-?[\d.]+|inf))+\s*$")
NUMBERS = re.compile(r"(?:bits = |T_map=|T_shuffle=|r\* = sqrt\(Ts/Tm\) = |"
                     r"load r = |vertices: |recovery bits: |state )(\S+)")


def _run(script: str, *args: str) -> str:
    env = {"PATH": os.environ.get("PATH", ""),
           "HOME": os.environ.get("HOME", str(ROOT)),
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script), *args],
                         capture_output=True, text=True, env=env, timeout=240,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _printed(text: str) -> tuple[list[str], list[str]]:
    rows = [ln.strip() for ln in text.splitlines() if ROW.match(ln)]
    return rows, NUMBERS.findall(text)


@pytest.mark.parametrize("port,ref", [
    ("port_quickstart.py", "quickstart.py"),
    ("port_coded_pagerank.py", "coded_pagerank.py"),
])
def test_port_example_prints_the_references_loads(port, ref):
    mine = _run(port, "--device", "cpu")
    theirs = _run(ref)
    rows, numbers = _printed(mine)
    assert len(rows) in (5, 6) and numbers
    assert (rows, numbers) == _printed(theirs)
    assert "device cpu" in mine and "rtol 1e-05" in mine


def test_port_train_lm_trains_and_restarts():
    """`examples/port_train_lm.py` on the CPU: a few steps of the reduced
    gemma-7b, a checkpoint, and a restart that resumes from it. Its data
    and weights are not JAX's bits, so its losses are not the reference
    example's; it prints the same lines."""
    out = _run("port_train_lm.py", "--device", "cpu", "--steps", "8")
    assert "training gemma-7b-smoke" in out and "device cpu" in out
    assert "restored from step 4" in out
    assert "restart resumed from step 4 (fault-tolerant)." in out
    assert re.search(r"loss: \d+\.\d+ -> \d+\.\d+", out)


def test_port_serve_lm_serves_both_archs():
    """`examples/port_serve_lm.py` on the CPU: 12 greedy tokens for 4
    prompts of the reduced internlm2-20b and mamba2-370m, as the
    reference's `examples/serve_lm.py`."""
    out = _run("port_serve_lm.py", "--device", "cpu")
    for arch in ("internlm2-20b", "mamba2-370m"):
        assert f"{arch:16s} batch=4 prompt=8 -> 12 new tokens per request" in out
    assert "batched serving OK" in out
