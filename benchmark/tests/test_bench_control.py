"""On the card: the control, the reference in the program's place with TF32
on, comes out not correct, where the program comes out correct, at the
1.9 MP cell's own size and limits (about 30 s; the 24 MP cell's readings
come from ``python3 -m benchmark.reference.readings``).

    python3 -m pytest benchmark/tests/test_bench_control.py -q -m cuda
"""

from __future__ import annotations

import pytest

from benchmark import scenes
from benchmark.reference import readings
from benchmark.run import Cell
from benchmark.tests.conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 5])
def test_control_fails_where_the_program_passes(cuda, seed):
    cell = Cell("ref19-exact.blind", ROOT)
    h, w, _ = cell.config["frame"]
    frame = scenes.make_scene(h, w, cell.config["kwargs"]["blur_width"], seed, cuda)
    limits = cell.config["limits"]
    program = readings.program_numbers(cell, frame, cuda)
    control = readings.control_numbers(cell, frame, cuda)
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control
