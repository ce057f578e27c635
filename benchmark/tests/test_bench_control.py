"""On the card: the control, the reference in the program's place with TF32
on, comes out not correct, where the program comes out correct, at the
cell's own size and limits (about 30 s a seed at 1.9 MP, 100 s at 24 MP;
the readings the limits were set from come from
``python3 -m benchmark.reference.readings``); and so does the program with
its step left unchanged on the 24 MP cell's larger levels alone, which
only ``fine_hp_gap`` compares.

    python3 -m pytest benchmark/tests/test_bench_control.py -q -m cuda
"""

from __future__ import annotations

import pytest

from benchmark import scenes
from benchmark.reference import readings
from benchmark.run import Cell
from benchmark.tests.conftest import ROOT, unchanged_from


@pytest.mark.cuda
@pytest.mark.parametrize("name, seed", [("ref19-exact.blind", 1), ("ref19-exact.blind", 5),
                                        ("cam24-exact.stored-psf", 2)])
def test_control_fails_where_the_program_passes(cuda, name, seed):
    cell = Cell(name, ROOT)
    cell.set_up()
    h, w, _ = cell.config["frame"]
    frame = scenes.make_scene(h, w, cell.config["kwargs"]["blur_width"], seed, cuda)
    limits = cell.limits
    program = readings.program_numbers(cell, frame, cuda)
    control = readings.control_numbers(cell, frame, cuda)
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control


@pytest.mark.cuda
@pytest.mark.parametrize("columns", [6000, 4000], ids=["full-frame", "0.707-and-1"])
def test_a_fault_in_the_larger_levels_is_not_correct(cuda, monkeypatch, columns):
    cell = Cell("cam24-exact.stored-psf", ROOT)
    cell.set_up()
    h, w, _ = cell.config["frame"]
    frame = scenes.make_scene(h, w, cell.config["kwargs"]["blur_width"], 2, cuda)
    limits = cell.limits
    unchanged_from(monkeypatch, columns)
    found = readings.program_numbers(cell, frame, cuda)
    assert found["fine_hp_gap"] > limits["fine_hp_gap"], found
    assert all(found[k] <= limits[k] for k in limits if k != "fine_hp_gap"), found
