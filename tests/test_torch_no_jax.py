"""The port never imports JAX or the JAX package: the machine with the GPU
has no JAX, and ``ics_tpu``'s package import loads it."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "ics_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "ics_tpu" or name.startswith("ics_tpu.")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and _forbidden(node.module or ""):
            bad.append(node.module)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_sees_the_port():
    names = {p.name for p in FILES}
    assert {"cli.py", "io.py", "filters.py", "cuda_bilateral.py", "chip_smoke.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"ics_tpu_torch/runtime/codecs.py", "ics_tpu_torch/runtime/loader.py",
            "ics_tpu_torch/utils/selftest.py", "ics_tpu_torch/examples/shard_deblur.py",
            "ics_tpu_torch/examples/deblur_cases.py"} <= rel
