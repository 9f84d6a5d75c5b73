"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the port either. Modules are compared
by their whole top-level name: the port's, repro_torch, begins with the
JAX package's, repro."""
import ast

import pytest

from gpubench_tiny import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_there_are_sources():
    assert len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert top_level_imports(path) <= {"__future__", "numpy", "torch"}


def test_the_comparison_is_by_whole_name(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.core\nfrom reprox import y\n")
    assert not top_level_imports(p) & FORBIDDEN
    p.write_text("import repro.core\n")
    assert top_level_imports(p) & FORBIDDEN
