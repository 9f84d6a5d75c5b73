"""The port stands alone: no JAX and no reference package in its imports.

An `ast` walk over every module of `src/repro_torch/` (its `experiments/`
package included), over `chip_smoke.py` and over the port's examples
(`examples/port_*.py`) finds every `import` / `from ... import` (including
those inside functions) and rejects `jax`, `jaxlib` and `repro` (anything
but `repro_torch`). Only the tests import both packages.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("port_*.py"))
BANNED = ("jax", "jaxlib", "repro")


def _imported(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_has_modules():
    assert len(FILES) > 20


def test_walk_covers_the_examples_and_experiments():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"examples/port_quickstart.py", "examples/port_coded_pagerank.py",
            "src/repro_torch/experiments/table2.py",
            "src/repro_torch/experiments/registry.py",
            "src/repro_torch/experiments/__main__.py",
            "src/repro_torch/graphs/io.py",
            "src/repro_torch/launch/dist.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT))
                                             for p in FILES])
def test_no_jax_and_no_reference_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.name} imports {bad}"

