"""Nothing under bench/ imports JAX or the JAX package; the reference
imports nothing of the port; nothing reads the JAX package's harness."""
import ast
from pathlib import Path

import pytest

from bench import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(cells.BENCH.rglob("*.py"))


def imported(path):
    """Top-level module names every import of ``path`` names."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            out.add(node.args[0].value.split(".")[0])
    return out


def test_files_found():
    assert any(p.name == "run.py" for p in FILES)
    assert any(p.parent.name == "reference" for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(cells.BENCH)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    (cells.BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_port(path):
    assert not imported(path) & (FORBIDDEN | {"repro_torch", "bench"})


def test_names_compared_whole():
    """``repro_torch`` is not ``repro``: the guard compares top-level
    names whole."""
    assert "repro_torch" not in FORBIDDEN
    assert imported(cells.BENCH / "run.py") & FORBIDDEN == set()


@pytest.mark.parametrize("path", [p for p in FILES if p != Path(__file__).resolve()],
                         ids=lambda p: str(p.relative_to(cells.BENCH)))
def test_no_jax_harness(path):
    text = path.read_text()
    assert "benchmarks/" not in text and "chip_smoke" not in text
