"""The port's examples (`examples/port_*.py`) run on the CPU and print what
the reference's examples print.

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
