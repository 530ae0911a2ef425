"""The benchmark imports neither JAX nor the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
plain reference imports nothing of the program."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((BENCH / "reference").glob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_files_found():
    assert len(FILES) > 15 and len(REFERENCE) >= 2


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in harness.FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_stands_alone(path):
    """The reference takes nothing of the program nor of the harness:
    torch, numpy, the standard library and its own modules only."""
    top = {m.split(".")[0] for m in _imports(path)
           if not m.startswith("benchmark.reference")}
    assert top <= {"torch", "numpy", "math", "contextlib", "typing",
                   "__future__"}, top


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "pcdms_tpu_torch_probe", object())
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()
