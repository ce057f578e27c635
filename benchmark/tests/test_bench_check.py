"""The plain reference against the port on a tiny frame on the CPU, a whole
run of a tiny cell (the chip's look skipped) and its result line, and the
same run with the timed path broken underneath: ``correct`` comes out
false for each fault this cell can have."""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import scenes
from benchmark.run import HERE, Cell, _Levels, _load, _program, result_line, run_cell
from benchmark.tests.conftest import ROOT, STORED, TINY, tiny_tree, unchanged_from

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
plain = Cell("cam24-exact.blind", ROOT).reference  # the reference, as the harness finds it
BLIND_ONLY = {"ms_per_outer.blind", "while_body_ms.blind", "kernels_per_outer.blind",
              "k2_roofline"}
KW = dict(blur_width=5, mask=[26, 35], mask_size=31, tolerance=0.1, quality="normal",
          iterations=200, blur="static", solver="mm", precision="exact")


@pytest.mark.parametrize("stored", [False, True], ids=["blind", "stored-psf"])
def test_reference_agrees_with_the_port(tmp_path, stored):
    kw = dict(KW)
    if stored:  # the mix's set-up writes the true PSF; the blind phase is skipped
        kw.update(_load(HERE / "traffic/stored-psf.py").prepare(
            SimpleNamespace(config=dict(kwargs=kw)), tmp_path))
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
    assert [r["case"] for r in own].count("blind") == (0 if stored else len(plain.pyramid(5)[0]))


@pytest.mark.parametrize("kw", [dict(use_tv=True), dict(nonblind_levels="final"),
                                dict(blind_budget=20), dict(resize_backend="scipy"),
                                dict(unknown_option=1)], ids=lambda kw: next(iter(kw)))
def test_the_reference_refuses_what_it_lacks(kw):
    with pytest.raises(ValueError, match=next(iter(kw))):
        plain.run(scenes.make_scene(52, 70, 5, 3, "cpu"), dict(KW, **kw), "cpu")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [TINY, STORED])
def test_result_line(tmp_path, name, trace):
    cell = Cell(name, tiny_tree(tmp_path))
    out = run_cell(cell, 2**31 + 99, 3.0, bool(trace), device="cpu")
    line = result_line(cell, out, bool(trace), "cpu")
    assert set(line) == KEYS | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks" and out["correct"] and line["attempted"] >= 2
    names = {m["name"] for m, _ in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    case = "blind" if name == TINY else "nonblind"
    assert (not trace) or {"outers_per_frame", f"ms_per_outer.{case}", "resize_ms"} <= set(
        line["metrics"])
    assert (not trace) or {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["checks"]) == set(cell.limits) <= set(plain.NUMBERS)
    if trace and name == STORED:  # a metric that the cell does not list reads nothing there
        readers = Cell(TINY, tiny_tree(tmp_path / "all")).per_layer
        assert all(reader.read(out["record"]) is None
                   for m, reader in readers if m["name"] in BLIND_ONLY)


def _unchanged_step(monkeypatch):
    """Each outer returns its state unchanged."""
    unchanged_from(monkeypatch)


def _unchanged_last_level(monkeypatch):
    """Each outer of the full-frame level alone returns its state unchanged
    (its planar iterate is the only one wider than the tiny frame)."""
    unchanged_from(monkeypatch, 57)


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


def _moved_tap(monkeypatch):
    """The program is handed a PSF whose centre tap is moved by one pixel;
    the reference reads the true one from the file."""
    from ics_tpu_torch.models import pipeline

    real = pipeline.load_checkpoint

    def load(path):
        ckpt = real(path)
        psf, c = ckpt.psf.copy(), ckpt.psf.shape[0] // 2
        psf[c, c + 1] += psf[c, c]
        psf[c, c] = 0.0
        ckpt.psf = psf
        return ckpt

    monkeypatch.setattr(pipeline, "load_checkpoint", load)


@pytest.mark.parametrize("fault, name", [
    (_unchanged_step, TINY), (_altered_answer, TINY), (_unchanged_step, STORED),
    (_altered_answer, STORED), (_moved_tap, STORED), (_unchanged_last_level, STORED)],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_broken_path_is_not_correct(tmp_path, monkeypatch, fault, name):
    cell = Cell(name, tiny_tree(tmp_path))
    fault(monkeypatch)
    out = run_cell(cell, 2**31 + 7, 3.0, False, device="cpu")
    assert out["checked"] and not out["correct"]
