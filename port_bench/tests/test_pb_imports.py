"""What the harness and the reference import, by each module's whole
top-level name (the port's name begins with the JAX package's, so a prefix
test would be wrong both ways)."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from port_bench import spec

HARNESS_FORBIDDEN = {"jax", "jaxlib", "flax", "tneq_tpu"}
REFERENCE_FORBIDDEN = HARNESS_FORBIDDEN | {"tneq_tpu_torch"}
FILES = sorted(p for p in spec.PKG.rglob("*.py") if "tests" not in p.parts)


def _tops(path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.PKG)))
def test_harness_imports_no_jax(path):
    assert not _tops(path) & HARNESS_FORBIDDEN


@pytest.mark.parametrize("path", sorted((spec.PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    tops = _tops(path)
    assert not tops & REFERENCE_FORBIDDEN
    assert tops <= {"__future__", "math", "typing", "numpy", "torch"}


def test_loaded_modules_hold_no_jax():
    """Every module of the harness and the port it drives, imported in a
    fresh process, loads no forbidden top-level module."""
    code = (
        "import importlib, pkgutil, sys, port_bench\n"
        "from port_bench import guard\n"
        "for m in pkgutil.walk_packages(port_bench.__path__, 'port_bench.'):\n"
        "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
        "import tneq_tpu_torch.apps.symmetry_breaking, tneq_tpu_torch.train.trainer\n"
        "print(guard.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_guard_compares_whole_top_level_names(monkeypatch):
    from port_bench import guard

    monkeypatch.setitem(sys.modules, "tneq_tpu_torchish", sys)
    assert guard.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert guard.forbidden_modules() == ["jax"]
