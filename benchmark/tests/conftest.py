"""Fixtures of the benchmark's own tests: a tiny cell on the CPU, in a copy
of the benchmark's files, and the GPU for the tests marked ``cuda``.

    python -m pytest benchmark/tests -q                 # on the CPU
    python3 -m pytest benchmark/tests -q -m cuda        # on the card
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
TINY = "tiny.blind"


def tiny_tree(tmp: Path, frame=(40, 56), blur=5, mask_size=23, check=(2, 2)) -> Path:
    """A copy of BENCHMARK.json and benchmark/ under ``tmp`` with one more
    configuration, a tiny frame on the ``blind`` mix, as the cell
    ``tiny.blind``; every metric lists it."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/ref19-exact.json").read_text())
    h, w = frame
    cfg.update(name="tiny", frame=[h, w, 3], check=dict(frames=check[0], among_first=check[1]))
    cfg["kwargs"].update(blur_width=blur, mask=[h // 2, w // 2], mask_size=mask_size)
    cfg["limits"] = dict(resize_gap=1e-5, u_gap=1e-4, psf_gap=1e-4, stop_gap=1e-3,
                         last_stop_gap=1e-3, codes_gap=3, post_gap=0)
    (tmp / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(bench["configs"][0], name="tiny",
                                 file="benchmark/configs/tiny.json"))
    bench["workloads"].append(dict(name=TINY, config="tiny", traffic="blind", chips=1, why="t"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(TINY)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny(tmp_path):
    from benchmark.run import Cell

    return Cell(TINY, tiny_tree(tmp_path))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")
