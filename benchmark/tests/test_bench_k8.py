"""The reader of K8, the MM step (``k8_per_outer``): on planted records, on
a tiny traced cell on the CPU (no WHILE solve, nothing to read), and on the
card, where every parity-mode op-loop body launches K8 ten times.

    python -m pytest benchmark/tests/test_bench_k8.py -q            # on the CPU
    python3 -m pytest benchmark/tests/test_bench_k8.py -q -m cuda   # on the card
"""

from __future__ import annotations

import pytest

from benchmark.run import Cell, _load, result_line, run_cell
from benchmark.tests.conftest import ROOT, STORED, TINY, tiny_tree

READER = ROOT / "benchmark/metrics/k8_per_outer.py"


def _solve(k8_per_body, outers, route="while"):
    launches = None if k8_per_body is None else dict(k1=10, k2=0, k7=1, k8=k8_per_body)
    return dict(route=route, outers=outers, k7w=outers, body_launches=launches)


@pytest.mark.parametrize("record, want", [
    (dict(frames=[dict(solves=[_solve(10, 120), _solve(10, 30)]),
                  dict(solves=[_solve(10, 5)])]), 10.0),
    (dict(frames=[dict(solves=[_solve(10, 30), _solve(0, 20)])]), 6.0),
    (dict(frames=[dict(solves=[_solve(0, 30), _solve(0, 10)])]), None),
    (dict(frames=[dict(solves=[dict(route="while", outers=4, k7w=4,
                                    body_launches=dict(k1=10, k7=1))])]), None),
    (dict(frames=[dict(solves=[_solve(None, 30), dict(route="host", outers=5)])]), None),
    (dict(frames=[dict(scene=0, wall_s=1.0)]), None),
], ids=["ten", "weighted", "no-k8", "no-k8-key", "no-body-launches", "no-solves"])
def test_k8_per_outer_reads_a_planted_record(record, want):
    assert _load(READER).read(record) == want


def test_the_cpu_cell_reads_no_k8(tmp_path):
    """On the CPU the solves take the host loop: K8's reader finds nothing
    and leaves the metric out, though the cell lists it."""
    cell = Cell(TINY, tiny_tree(tmp_path))
    assert "k8_per_outer" in {m["name"] for m, _ in cell.per_layer}
    out = run_cell(cell, 2**31 + 81, 1.0, True, device="cpu")
    line = result_line(cell, out, True, "cpu")
    assert out["correct"], line["checks"]
    assert "k8_per_outer" not in line["metrics"]


@pytest.mark.cuda
def test_k8_runs_every_stored_psf_body_on_the_card(cuda, tmp_path):
    """A small stored-PSF cell traced on the card, 400 x 600 with blur 5: both
    levels' windows (405 x 605, 285 x 426) are too large for K2
    (``cuda_solver.fits``), so every solve is a parity-mode op loop whose
    body launches K8 ten times (two a step, five steps), and the run is
    ``correct``.  (The 40 x 56 tiny frame runs K2 alone.)"""
    cell = Cell(STORED, tiny_tree(tmp_path, frame=(400, 600)))
    out = run_cell(cell, 2**31 + 83, 2.0, True, device="cuda")
    line = result_line(cell, out, True, "cuda")
    solves = [s for f in out["record"]["frames"] for s in f.get("solves") or ()]
    assert solves and all(s["body_launches"]["k8"] == 10 for s in solves
                          if s["route"] == "while"), solves
    assert line["metrics"]["k8_per_outer"]["value"] == 10.0, line["metrics"]
    assert out["correct"], line["checks"]
