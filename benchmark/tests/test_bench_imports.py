"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

from __future__ import annotations

import ast

import pytest

from benchmark.tests.conftest import ROOT

FILES = sorted(p for p in (ROOT / "benchmark").rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) and (
                node.value.split(".")[0] in ("jax", "ics_tpu")):
            yield node.value.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    found = set(_imports(path)) & {"jax", "jaxlib", "flax", "ics_tpu"}
    if path.name in ("run.py", "test_bench_imports.py"):  # they name them to look for them
        found -= {"jax", "ics_tpu"}
    assert not found, f"{path} imports {found}"


# readings.py is not the reference: it runs the program and the reference side by side
@pytest.mark.parametrize("path", sorted(p for p in (ROOT / "benchmark/reference").glob("*.py")
                                        if p.name != "readings.py"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "ics_tpu_torch" not in set(_imports(path))
    assert "ics_tpu_torch" not in path.read_text()


def test_the_check_compares_whole_names():
    from benchmark.run import FORBIDDEN

    names = {"ics_tpu_torch", "ics_tpu_torch.models", "jaxtyping", "numpy"}
    assert not {n.split(".")[0] for n in names} & set(FORBIDDEN)
    assert {n.split(".")[0] for n in ("jax.numpy", "ics_tpu.ops")} <= set(FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name != "reference"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_only_the_cell_names_the_reference(path):
    """Outside ``reference/`` a cell's reference comes from ``run.Cell``, which
    loads the one its configuration names: no file imports ``plain``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module == "benchmark.reference":
            assert "plain" not in {a.name for a in node.names}, path
        elif isinstance(node, ast.Import):
            assert "benchmark.reference.plain" not in {a.name for a in node.names}, path
