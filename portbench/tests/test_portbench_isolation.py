"""Nothing of the benchmark imports JAX or the JAX package, its reference
imports nothing of the program, and no module reads the JAX package's
benchmark folder or script. Names are compared whole, by
their top-level part: `jperceiver_tpu_torch` is not `jperceiver_tpu`."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from portbench import run

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "jperceiver_tpu"}


def imported(path: Path) -> set[str]:
    """Top-level names of every module the file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "jperceiver_tpu_torch" not in imported(path)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_nothing_reads_the_jax_benchmark(path):
    assert not imported(path) & {"benchmarks", "bench"}
    strings = [n.value for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    names = ("bench" + "marks/", "bench" + ".py")
    assert not [s for s in strings if any(n in s for n in names)]


def test_the_run_checks_loaded_modules_by_whole_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jperceiver_tpu_torch_x", types.ModuleType("x"))
    assert run.forbidden_modules() == [m for m in ("jax", "jaxlib", "flax", "optax",
                                                   "jperceiver_tpu") if m in sys.modules]
    monkeypatch.setitem(sys.modules, "jperceiver_tpu.models", types.ModuleType("y"))
    assert "jperceiver_tpu" in run.forbidden_modules()
