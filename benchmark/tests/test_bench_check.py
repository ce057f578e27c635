"""The plain reference against the port on a tiny frame on the CPU, a whole
run of a tiny cell (the chip's look skipped) and its result line, and the
same run with the timed path broken underneath: ``correct`` comes out
false for each fault this cell can have."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

from benchmark import scenes
from benchmark.reference import plain
from benchmark.run import _Levels, _program, result_line, run_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def test_reference_agrees_with_the_port():
    kw = dict(blur_width=5, mask=[26, 35], mask_size=31, tolerance=0.1, quality="normal",
              iterations=200, blur="static", solver="mm", precision="exact")
    frame = scenes.make_scene(52, 70, 5, 3, "cpu")
    levels = _Levels(keep=True)
    with contextlib.redirect_stdout(None):
        got = _program()[0](frame, "f", None, verbose=False, stats_out=levels, device="cpu", **kw)
    found = plain.run(frame, kw, "cpu", follow=levels.records(), program_codes=got)
    assert found["resize_gap"] < 1e-6 and found["u_gap"] < 1e-5 and found["psf_gap"] < 1e-5
    assert found["stop_gap"] < 1e-4 and found["last_stop_gap"] < 1e-4
    assert found["codes_gap"] <= 2 and found["post_gap"] == 0
    codes, own = plain.run(frame, kw, "cpu")
    assert codes.shape == got.shape and np.abs(codes.astype(int) - got).max() <= 2
    assert [r["case"] for r in own] == [lv["case"] for lv in levels]


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(tiny, trace):
    out = run_cell(tiny, 2**31 + 99, 3.0, bool(trace), device="cpu")
    line = result_line(tiny, out, bool(trace), "cpu")
    assert set(line) == KEYS | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks" and out["correct"] and line["attempted"] >= 2
    names = {m["name"] for m, _ in (tiny.per_layer if trace else tiny.end_to_end)}
    assert set(line["metrics"]) <= names
    assert (not trace) or {"outers_per_frame", "ms_per_outer.blind", "resize_ms"} <= set(
        line["metrics"])
    assert (not trace) or {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["checks"]) == set(tiny.config["limits"]) <= set(plain.NUMBERS)


def _unchanged_step(monkeypatch):
    """Each outer returns its state unchanged (the residual recomputed)."""
    from ics_tpu_torch.models import rl_mm

    real = rl_mm.inner_loop_ops

    def step(u, image, psf, **kw):
        _, psf_out, error, image_out = real(u, image, psf, **kw)
        return u, psf, error, image_out

    monkeypatch.setattr(rl_mm, "inner_loop_ops", step)


def _altered_answer(monkeypatch):
    """One 16-bit code of the answer changed where it is produced."""
    from ics_tpu_torch.models import pipeline

    real = pipeline._postprocess

    def post(img):
        out, nan = real(img)
        out = out.clone()
        out[out.shape[0] // 2, out.shape[1] // 2, 0] += 50
        return out, nan

    monkeypatch.setattr(pipeline, "_postprocess", post)


@pytest.mark.parametrize("fault", [_unchanged_step, _altered_answer])
def test_a_broken_path_is_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    out = run_cell(tiny, 2**31 + 7, 3.0, False, device="cpu")
    assert out["checked"] and not out["correct"]
