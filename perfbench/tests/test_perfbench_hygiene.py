"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere under ``perfbench/``, nothing of the program in the reference
modules, and the program only in ``program.py`` and the adapters.
Top-level module names are compared whole (``repro_torch`` is not
``repro``)."""
from __future__ import annotations

import ast

import pytest
from perfbench_tiny import ROOT

FILES = sorted((ROOT / "perfbench").rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_and_no_reference_package(path):
    assert not top_level_imports(path) & JAX


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").rglob("*.py"):
        names = top_level_imports(path)
        assert "repro_torch" not in names and not names & JAX, path
        assert names <= {"__future__", "math", "typing", "torch"}, names


def test_only_program_py_imports_the_program():
    """``program.py`` and the configurations' adapters, and no other file
    of the harness."""
    users = {str(p.relative_to(ROOT / "perfbench")) for p in FILES
             if "tests" not in p.parts and "repro_torch" in
             top_level_imports(p)}
    adapters = {p for p in users if p.startswith("adapters/")}
    assert users - adapters == {"program.py"}
    assert adapters, "no adapter imports the program"


def test_run_refuses_a_loaded_jax_module(monkeypatch):
    import sys
    import types

    from perfbench import run
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "repro_torch_extra",
                        types.ModuleType("y"))
    assert "jax" in run.forbidden_modules()
    assert "repro_torch_extra" not in run.forbidden_modules()
