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
STORED = "tiny.stored-psf"


def tiny_tree(tmp: Path, frame=(40, 56), blur=5, mask_size=23, check=(2, 2)) -> Path:
    """A copy of BENCHMARK.json and benchmark/ under ``tmp`` with one more
    configuration, a tiny frame, in two cells: ``tiny.blind`` on the
    ``blind`` mix, which every metric lists, and ``tiny.stored-psf`` on the
    ``stored-psf`` mix, with the limits of ``cam24-exact.stored-psf`` over
    its configuration's, which the metrics list that list that cell."""
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
    # the tiny stored-psf cell compares the numbers that the 24 MP one does,
    # under the same limits (cells/<cell>.json over the configuration's)
    shutil.copy(ROOT / "benchmark/cells/cam24-exact.stored-psf.json",
                tmp / f"benchmark/cells/{STORED}.json")
    bench["configs"].append(dict(bench["configs"][0], name="tiny",
                                 file="benchmark/configs/tiny.json"))
    bench["workloads"] += [dict(name=TINY, config="tiny", traffic="blind", chips=1, why="t"),
                           dict(name=STORED, config="tiny", traffic="stored-psf", chips=1,
                                why="t")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(TINY)
            if "cam24-exact.stored-psf" in m["workloads"]:
                m["workloads"].append(STORED)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def unchanged_from(monkeypatch, columns: int = 0) -> None:
    """A planted fault: each outer of a solve whose planar iterate has
    ``columns`` columns or more returns its state unchanged (the residual
    recomputed)."""
    from ics_tpu_torch.models import rl_mm

    real = rl_mm.inner_loop_ops

    def step(u, image, psf, **kw):
        out = real(u, image, psf, **kw)
        return (u, psf, *out[2:]) if u.shape[-1] >= columns else out

    monkeypatch.setattr(rl_mm, "inner_loop_ops", step)


@pytest.fixture
def tiny(tmp_path):
    from benchmark.run import Cell

    return Cell(TINY, tiny_tree(tmp_path))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")
