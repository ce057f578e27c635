"""The TV-MM cell's pieces: K5's work against its bound, the two readers of
K5 on planted records, a whole traced run of a tiny TV-MM cell (on the CPU,
where neither reader finds anything, and on the card, where K5's launches
pair with the calls the harness saw), and on the card the control, the
program and the program with a fault in its non-blind levels at the TV-MM
cell's own size and limits.

    python -m pytest benchmark/tests/test_bench_tv.py -q            # on the CPU
    python3 -m pytest benchmark/tests/test_bench_tv.py -q -m cuda   # on the card
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import scenes
from benchmark.kernels import k5
from benchmark.reference import readings
from benchmark.roofline import bound_s
from benchmark.run import Cell, _load, result_line, run_cell
from benchmark.tests.conftest import ROOT, tiny_tree

TV = "tinytv.blind"
METRICS = ROOT / "benchmark/metrics"


def tv_tree(tmp):
    """``tiny_tree`` with one more configuration, ``cam24-tv`` at a tiny frame
    in the cell ``tinytv.blind``, which every metric lists that lists
    ``cam24-tv.blind``, under its limits but three of the non-blind levels'.
    At 48 x 64 the non-blind TV solves run hundreds of outers, where the 24 MP
    frame's run 3-5, and their float32 rounding grows past the 24 MP limits
    (on the card's scene 0 ``rms_gap`` 2.24e-4; on the CPU ``fine_hp_gap``
    9.8e-5 and ``last_stop_gap`` 1.9e-3; PERF.md section 2 (c)): ``rms_gap``
    is not compared, the other two under the CPU test's limits
    (``tests/test_torch_tv_reference.py``)."""
    root = tiny_tree(tmp)
    cfg = json.loads((ROOT / "benchmark/configs/cam24-tv.json").read_text())
    cfg.update(name="tinytv", frame=[48, 64, 3], check=dict(frames=2, among_first=2))
    cfg["kwargs"].update(blur_width=5, mask=[24, 32], mask_size=23)
    (root / "benchmark/configs/tinytv.json").write_text(json.dumps(cfg))
    (root / f"benchmark/cells/{TV}.json").write_text(json.dumps(
        dict(limits=dict(rms_gap=None, fine_hp_gap=3e-4, last_stop_gap=2e-2))))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tinytv",
                                 file="benchmark/configs/tinytv.json"))
    bench["workloads"].append(dict(name=TV, config="tinytv", traffic="blind", chips=1, why="t"))
    for m in bench["per_layer"]:
        if "cam24-tv.blind" in m["workloads"]:
            m["workloads"].append(TV)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_k5_bound():
    """864 MB, 0.258 ms on 3x4001x6001 (PERF.md's kernel table): u read once,
    the magnitude and the divergence written once; the operations bound it
    far below."""
    ops, nbytes = k5.work(_meta(3, 4001, 6001), 1e-6, 2, 2)
    assert nbytes == 3 * 3 * 4001 * 6001 * 4
    assert bound_s(ops, nbytes) * 1e3 == pytest.approx(0.2580, abs=5e-5)
    assert bound_s(ops, 0) < bound_s(0, nbytes) / 5
    assert k5.work(_meta(3, 10, 10), 1e-2)[0] == 28 * 3 * 8 * 8  # order 2, L1 by default
    half = k5.work(torch.empty((3, 10, 10), dtype=torch.bfloat16, device="meta"), 1e-2)[1]
    assert half == 3 * 3 * 100 * 2


def _solve(k5_per_body, outers, route="while"):
    launches = None if k5_per_body is None else dict(k1=36, k3=10, k5=k5_per_body, k7=1)
    return dict(route=route, outers=outers, k7w=outers, body_launches=launches)


@pytest.mark.parametrize("record, want", [
    (dict(frames=[dict(solves=[_solve(12, 200), _solve(12, 50)]),
                  dict(solves=[_solve(12, 10)])]), 12.0),
    (dict(frames=[dict(solves=[_solve(12, 30), _solve(0, 10)])]), 9.0),
    (dict(frames=[dict(solves=[_solve(0, 30), _solve(0, 10)])]), None),
    (dict(frames=[dict(solves=[_solve(None, 30), dict(route="host", outers=5)])]), None),
    (dict(frames=[dict(scene=0, wall_s=1.0)]), None),
    (dict(frames=[dict(solves=[dict(route="while", outers=1, k7w=0, body_launches=None)])]),
     None),
], ids=["twelve", "weighted", "no-k5", "no-body-launches", "no-solves", "no-graph"])
def test_k5_per_outer_reads_a_planted_record(record, want):
    assert _load(METRICS / "k5_per_outer.py").read(record) == want


@pytest.mark.parametrize("kernels, want", [
    (dict(k5=dict(calls=12, launches=12, device_s=2.0, bound_s=1.0)), 50.0),
    (dict(k5=dict(calls=0, launches=12, device_s=2.0, bound_s=0.0)), None),
    (dict(k5=dict(calls=0, launches=0, device_s=0.0, bound_s=0.0)), None),
    (dict(k1=dict(calls=3, launches=3, device_s=1.0, bound_s=0.5)), None),
], ids=["paired", "calls-unseen", "no-k5", "no-k5-entry"])
def test_k5_roofline_reads_a_planted_record(kernels, want):
    assert _load(METRICS / "k5_roofline.py").read(dict(profile=dict(kernels=kernels))) == want
    assert _load(METRICS / "k5_roofline.py").read(dict(frames=[])) is None


def test_the_tv_cell_runs_traced_on_the_cpu(tmp_path):
    """The tiny TV-MM cell through the harness on the CPU: ``correct`` under
    its limits, its reference ``mm_tv``, and neither K5 reader finds anything
    (no K5 launch, no WHILE solve)."""
    cell = Cell(TV, tv_tree(tmp_path))
    assert cell.reference.__name__.endswith("mm_tv") and cell.kwargs()["use_tv"]
    out = run_cell(cell, 2**31 + 21, 1.0, True, device="cpu")
    line = result_line(cell, out, True, "cpu")
    assert out["correct"], line["checks"]
    assert set(line["checks"]) == set(cell.limits) <= set(cell.reference.NUMBERS)
    assert not {"k5_roofline", "k5_per_outer"} & set(line["metrics"])
    assert {"k5_roofline", "k5_per_outer"} <= {m["name"] for m, _ in cell.per_layer}
    assert "k2_roofline" not in {m["name"] for m, _ in cell.per_layer}


@pytest.mark.cuda
def test_k5_pairs_launches_with_calls_on_the_card(cuda, tmp_path):
    """The tiny TV-MM cell traced on the card: at the profiled frame every K5
    launch is a call the harness saw through ``cuda_tv.tv_planar``, each
    WHILE body launches K5 12 times (``tv(ut, 1)``, ``tv(ut, 2)`` once and
    ``tv(u, 1)``, ``tv(u, 2)`` in each of five inner steps), and the run is
    ``correct``."""
    cell = Cell(TV, tv_tree(tmp_path))
    out = run_cell(cell, 2**31 + 33, 2.0, True, device="cuda")
    k = out["record"]["profile"]["kernels"]["k5"]
    assert k["launches"] == k["calls"] > 0, k
    line = result_line(cell, out, True, "cuda")
    assert line["metrics"]["k5_per_outer"]["value"] == 12.0, line["metrics"]
    assert 0.0 < line["metrics"]["k5_roofline"]["value"] <= 100.0
    assert out["correct"], line["checks"]


def _frame(cell, seed, device):
    cell.set_up()
    h, w, _ = cell.config["frame"]
    return scenes.make_scene(h, w, cell.config["kwargs"]["blur_width"], seed, device)


@pytest.mark.cuda
@pytest.mark.parametrize("name, seed", [("cam24-tv.blind", 2)])
def test_control_fails_where_the_program_passes(cuda, record_property, name, seed):
    """The TV-MM cell at its own size and limits: the program within every
    limit, the control (the reference with TF32 on) over one."""
    cell = Cell(name, ROOT)
    frame = _frame(cell, seed, cuda)
    limits = cell.limits
    program = readings.program_numbers(cell, frame, cuda)
    control = readings.control_numbers(cell, frame, cuda)
    record_property("numbers", json.dumps(dict(program=program, control=control)))
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control


@pytest.mark.cuda
def test_a_fault_in_the_nonblind_levels_is_not_correct(cuda, monkeypatch, record_property):
    """The TV-MM cell at its own size and limits, its non-blind levels
    regularised with the blind levels' ε (1e-2 in place of 1e-6): over a
    limit of the non-blind levels, within those of the blind levels alone."""
    from ics_tpu_torch.models import rl_mm

    cell = Cell("cam24-tv.blind", ROOT)
    frame = _frame(cell, 2, cuda)
    limits = cell.limits
    monkeypatch.setattr(rl_mm, "_EPS_NONBLIND", rl_mm._EPS_BLIND)
    found = readings.program_numbers(cell, frame, cuda)
    record_property("numbers", json.dumps(found))
    over = {k for k in limits if found[k] > limits[k]}
    assert over and not {"denoised_gap", "blind_u_gap", "psf_gap"} & over, found
