"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the program: checked on the sources (every
import statement, by whole top-level name) and, for the run's guard, on
module names."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from benchmark import run

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "damvsnet_tpu"}


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported_roots(path) & (FORBIDDEN | {"damvsnet_tpu_torch"})


def test_run_guard_compares_whole_top_level_names():
    port = ["damvsnet_tpu_torch", "damvsnet_tpu_torch.model", "jax_probe", "torch"]
    assert run.forbidden_modules(port) == []
    assert run.forbidden_modules(port + ["damvsnet_tpu.model", "jaxlib"]) == [
        "damvsnet_tpu", "jaxlib"]
