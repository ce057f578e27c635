"""The stamped pass's readers on a synthetic ``record["stamped"]``, and the
pass itself on a tiny cell (on the CPU: spans without stamps)."""

from __future__ import annotations

import json

import pytest

from benchmark import stamped
from benchmark.run import HERE, Cell, _load, run_cell
from benchmark.tests.conftest import ROOT

NEW = ("while_body_ms.blind", "while_body_ms.nonblind", "kernels_per_outer.blind",
       "kernels_per_outer.nonblind", "capture_wait_ms", "host_wait_pct")
US = 1000  # the synthetic times below are in microseconds


def _span(id_, name, parent, host, device=None, seq=None, info=None, k7w=None):
    s = dict(name=name, id=id_, parent=parent, frame=1, host=tuple(t * US for t in host),
             device=None if device is None else tuple(t * US for t in device),
             seq=seq, info=info)
    if k7w is not None:
        s["k7w"] = [t * US for t in k7w]
    return s


def _frame():
    """One frame: a blind solve of 4 bodies of 50 us (10 kernels each), a
    non-blind one of 4 bodies of 50 us (20 kernels); idle gaps 10, 80
    (the blind capture), 20, 10 (the non-blind capture) and 10 us in a
    device window of 880 us."""
    blind = dict(route="while", body_nodes=dict(kernel=10, memcpy=1, memset=0, other=2))
    nonblind = dict(route="while", body_nodes=dict(kernel=20, memcpy=1, memset=1, other=2))
    spans = [
        _span(1, "frame", None, (0, 1000)),
        _span(2, "upload + preprocess", 1, (10, 100), (100, 150), (0, 1)),
        _span(3, "solve (blind)", 1, (110, 500), (160, 600), (2, 7)),
        _span(4, "outer 1", 3, (120, 200), (200, 250), (3, 4), blind),
        _span(5, "capture", 3, (210, 300), info=blind),
        _span(6, "build", 3, (300, 320), info=blind),
        _span(7, "while", 3, (320, 480), (330, 530), (5, 6), blind, [330, 380, 430, 480, 530]),
        _span(8, "solve (non-blind)", 1, (510, 900), (620, 950), (8, 13)),
        _span(9, "outer 1", 8, (515, 600), (630, 700), (9, 10), nonblind),
        _span(10, "capture", 8, (600, 690), info=nonblind),
        _span(11, "build", 8, (690, 700), info=nonblind),
        _span(12, "while", 8, (700, 890), (710, 910), (11, 12), nonblind,
              [710, 760, 810, 860, 910]),
        _span(13, "postprocess + download", 1, (910, 990), (960, 980), (14, 15)),
    ]
    return dict(scene=0, wall_s=0.001, spans=spans, solves=[blind, nonblind], clock_err_ns=900,
                drift_ns=0)


READERS = {m["name"]: reader for m, reader in Cell("ref19-exact.blind", ROOT).per_layer}


def _read(name, record):
    return READERS[name].read(record)


def test_the_readers_on_a_stamped_frame():
    record = dict(stamped=[_frame(), _frame()])
    assert _read("while_body_ms.blind", record) == pytest.approx(0.05)
    assert _read("while_body_ms.nonblind", record) == pytest.approx(0.05)
    assert _read("kernels_per_outer.blind", record) == 10
    assert _read("kernels_per_outer.nonblind", record) == 20
    assert _read("capture_wait_ms", record) == pytest.approx(0.09)
    assert _read("host_wait_pct", record) == pytest.approx(100 * 130 / 880)


def test_the_gaps_and_who_the_host_was_busy_with():
    frame = _frame()
    assert stamped.gaps(frame) == [(a * US, b * US) for a, b in
                                   ((150, 160), (250, 330), (600, 620), (700, 710), (950, 960))]
    assert stamped.capture_waits_ms(frame) == pytest.approx([0.08, 0.01])
    # the host during each gap: in 'outer 1' of the blind solve (10), its
    # capture, build and launch (50, 20, 10), the non-blind capture (20) and
    # launch (10), the download (10)
    assert stamped.gaps_by_span(frame) == {
        "outer 1": 10 * US, "capture": 70 * US, "build": 20 * US, "while": 20 * US,
        "postprocess + download": 10 * US}


def test_bodies_weight_the_kernel_count():
    frame = _frame()
    frame["spans"][11]["k7w"] = frame["spans"][11]["k7w"][:3]  # 2 non-blind bodies
    frame["spans"][11]["info"] = dict(body_nodes=dict(kernel=40))
    record = dict(stamped=[_frame(), frame])
    assert _read("kernels_per_outer.nonblind", record) == pytest.approx((20 * 4 + 40 * 2) / 6)
    assert _read("while_body_ms.nonblind", record) == pytest.approx((0.2 + 0.1) / 6)


@pytest.mark.parametrize("name", NEW)
def test_the_readers_read_nothing_without_stamps(name):
    assert _read(name, dict(stamped=None)) is None
    assert _read(name, dict(stamped=[])) is None
    empty = dict(stamped=[dict(_frame(), spans=[_span(1, "frame", None, (0, 10))])])
    assert _read(name, empty) is None
    assert _read(name, {"frames": []}) is None  # no pass in the record: nothing read


def test_a_pass_that_raises_fails_the_run(monkeypatch, tiny):
    """In a traced harness run a failing pass is not read as 'nothing
    stamped': it raises, and with it the run."""

    def broken(cell, dev, seconds, pool=None):
        raise RuntimeError("illegal memory access")

    monkeypatch.setattr(stamped, "run_pass", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        run_cell(tiny, 2**31 + 3, 0.5, True, device="cpu")


def test_the_new_metrics_are_in_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mine = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}
    assert list(mine) == list(NEW) and [m["name"] for m in bench["per_layer"][-6:]] == list(NEW)
    layers = {m["layer"] for m in bench["per_layer"] if m["name"] not in NEW}
    for m in mine.values():
        assert m["moves"] == "frame_s" and m["layer"] in layers
        # a blind body is read only where the mix runs the blind phase
        assert m["workloads"] == [w["name"] for w in bench["workloads"]
                                  if w["traffic"] == "blind" or not m["name"].endswith(".blind")]


def test_the_pass_on_a_tiny_cell_on_the_cpu(tiny):
    import torch

    out = stamped.run_pass(tiny, torch.device("cpu"), seconds=0.0)
    assert [f["scene"] for f in out] == list(range(tiny.mix["pool"]))
    for f in out:
        names = [s["name"] for s in f["spans"]]
        assert names[0] == "frame" and "solve (blind)" in names and "solve (non-blind)" in names
        assert all(s["device"] is None for s in f["spans"]) and f["wall_s"] > 0
        assert all(s["parent"] == f["spans"][0]["id"] for s in f["spans"][1:])
    assert stamped.host_wait_pct(dict(stamped=out)) is None


@pytest.mark.cuda
def test_the_pass_reads_on_the_card(tiny, cuda):
    record = dict(stamped=stamped.run_pass(tiny, cuda, seconds=0.0))
    for name in NEW:
        assert _read(name, record) is not None, name
    assert 0.0 <= _read("host_wait_pct", record) < 100.0
    counts = {f["scene"]: [s["body_nodes"]["kernel"] for s in f["solves"]]
              for f in record["stamped"]}
    assert all(all(k > 0 for k in c) for c in counts.values())


@pytest.mark.cuda
def test_the_stored_psf_cell_reads_on_the_card(cuda):
    """A short traced run of ``cam24-exact.stored-psf`` itself on the card
    (about a minute; its window holds the first four frames, among which
    the check draws its frame): each per-layer metric that lists the cell
    reads a value, each that does not (the blind bodies, K2, whose window
    the full frame does not fit) reads nothing, not 0."""
    cell = Cell("cam24-exact.stored-psf", ROOT)
    out = run_cell(cell, 2**31 + 5, 8.0, True, device="cuda")
    assert out["correct"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        value = _load(HERE / "metrics" / f"{m['name']}.py").read(out["record"])
        if cell.name in m["workloads"]:
            assert value is not None and value > 0, m["name"]
        else:
            assert value is None, (m["name"], value)
