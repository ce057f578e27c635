"""The port's stage tracer on the CPU: ``Tracer()`` synchronizes and
accumulates as it always has; ``Tracer(sync=False)`` records spans (names,
ids, parents, frames, host times) and, with no CUDA device, no stamps; the
solves' host-loop log is unchanged."""

import contextlib

import numpy as np
import pytest
import torch

from ics_tpu_torch.models import pipeline
from ics_tpu_torch.models import rl_mm as trl
from ics_tpu_torch.models.pipeline import deblur_module
from ics_tpu_torch.utils import trace
from ics_tpu_torch.utils.trace import Tracer

FRAME = (np.random.default_rng(0).random((40, 56, 3)) * 255).astype(np.uint8)
KW = dict(mask_size=23, iterations=3, verbose=False, device="cpu")


def test_sync_tracer_accumulates_stages_as_before():
    tracer = Tracer()
    assert tracer.sync is True
    for _ in range(3):
        with tracer.stage("a"):
            pass
    with tracer.stage("b"):
        pass
    assert {n: s.count for n, s in tracer._stages.items()} == {"a": 3, "b": 1}
    assert [line.split()[0] for line in tracer.report().splitlines()] in (["a", "b"],
                                                                          ["b", "a"])
    assert "(3×)" in tracer.report()
    with tracer.frame("cpu"):  # a no-op for a synchronizing tracer
        assert trace.active() is None
    assert tracer.collect() == []


def test_stamping_tracer_nests_spans_with_host_times():
    tracer = Tracer(sync=False)
    entry = dict(route="while")
    with tracer.frame("cpu"):
        assert trace.active() is tracer
        with tracer.stage("outer"):
            with tracer.span("inner", entry):
                pass
            with tracer.span("host only", device=False):
                pass
        with tracer.stage("outer"):
            pass
    assert trace.active() is None
    spans = tracer.collect()
    assert [s["name"] for s in spans] == ["frame", "outer", "inner", "host only", "outer"]
    frame, outer, inner, host, again = spans
    assert [s["parent"] for s in spans] == [None, frame["id"], outer["id"], outer["id"],
                                            frame["id"]]
    assert len({s["id"] for s in spans}) == 5 and {s["frame"] for s in spans} == {1}
    assert inner["info"] is entry and outer["info"] is None
    for s in spans:
        assert s["device"] is None and s["seq"] is None
        assert s["host"][0] <= s["host"][1]
    assert frame["host"][0] <= outer["host"][0] <= inner["host"][0] <= inner["host"][1] \
        <= host["host"][0] <= host["host"][1] <= outer["host"][1] <= again["host"][0]
    assert tracer._stages["outer"].count == 2 and tracer.collect() == []
    with tracer.frame("cpu"):
        pass
    assert tracer.collect()[0]["frame"] == 2


def test_stamping_tracer_leaves_the_context_on_an_error():
    tracer = Tracer(sync=False)
    with pytest.raises(RuntimeError, match="inside"), tracer.frame("cpu"), tracer.stage("s"):
        raise RuntimeError("inside")
    assert trace.active() is None and not tracer._open
    spans = tracer.collect()
    assert [s["name"] for s in spans] == ["frame", "s"] and all(s["host"][1] for s in spans)


def test_collect_with_a_span_open_raises():
    tracer = Tracer(sync=False)
    with tracer.stage("open"), pytest.raises(RuntimeError, match="open"):
        tracer.collect()


def test_a_cpu_tracer_stamps_nothing():
    tracer = Tracer(sync=False)
    with tracer.frame("cpu"):
        assert tracer.device is None and tracer.k7w_stamps(8, "cpu") is None
    with pytest.raises(ValueError, match="CUDA"):
        tracer.calibrate()
    with pytest.raises(ValueError, match="CUDA"):
        trace.stamp(torch.zeros(4, dtype=torch.int64), 0)
    assert tracer.clock_err_ns is None


def test_profiler_offset_is_the_wall_clock_less_the_tracer_clock():
    import time

    offset = trace.profiler_offset_ns()
    assert abs(time.time_ns() - time.perf_counter_ns() - offset) < 5_000_000


def test_deblur_module_spans_on_the_cpu():
    """A stamping tracer over a CPU frame: one root span, every stage under
    it, the same output as an untraced frame; solves on the CPU take the
    host loop and open no spans of their own."""
    want = deblur_module(FRAME, "x", None, 5, **KW)
    tracer = Tracer(sync=False)
    trl.loop_log.clear()
    got = deblur_module(FRAME, "x", None, 5, trace=tracer, **KW)
    assert np.array_equal(got, want)
    spans = tracer.collect()
    root = spans[0]
    assert root["name"] == "frame" and root["parent"] is None
    assert all(s["parent"] == root["id"] for s in spans[1:])
    names = [s["name"] for s in spans[1:]]
    assert names[:2] == ["upload + preprocess", "pad + psf upload"]
    assert names[-1] == "postprocess + download"
    assert {"resize + pad", "solve (blind)", "pad (non-blind)", "solve (non-blind)"} <= set(names)
    assert all(e["route"] == "host" for e in trl.loop_log)


def test_every_pad_lies_in_a_stage(monkeypatch):
    """The statements that launch device work outside the solvers, here the
    edge pads (the odd-size pad and the non-blind level's pad among them),
    run inside a stage span."""
    tracer, seen = Tracer(sync=False), []
    pad = pipeline._pad_edge

    def watched(*a):
        seen.append([s.name for s in tracer._open])
        return pad(*a)

    monkeypatch.setattr(pipeline, "_pad_edge", watched)
    frame = np.ascontiguousarray(FRAME[:, :54])  # even sizes: the odd-size pads run
    deblur_module(frame, "x", None, 5, trace=tracer, **KW)
    assert len(seen) > 4 and all(len(open_) >= 2 for open_ in seen)
    assert any(open_[-1] == "pad (non-blind)" for open_ in seen)
    assert sum(open_[-1] == "pad + psf upload" for open_ in seen) == 2


@pytest.mark.parametrize("solver", ["mm", "pam", "pd"])
def test_host_loop_entries_keep_their_keys(solver):
    """A host-loop solve logs the six keys it always did, traced or not;
    only WHILE entries have ``body_nodes``."""
    from ics_tpu_torch.models.rl_pam import richardson_lucy_PAM
    from ics_tpu_torch.models.rl_pd import richardson_lucy_PD

    fn = {"mm": trl.richardson_lucy_MM, "pam": richardson_lucy_PAM,
          "pd": richardson_lucy_PD}[solver]
    image = torch.rand((24, 24, 3), generator=torch.Generator().manual_seed(3)) * 0.5 + 0.2
    u = torch.nn.functional.pad(image.permute(2, 0, 1)[None], (1,) * 4,
                                mode="replicate")[0].permute(1, 2, 0).contiguous()
    psf = torch.full((3, 3, 3), 1.0 / 9)
    tracer = Tracer(sync=False)
    for traced in (False, True):
        trl.loop_log.clear()
        with tracer.frame("cpu") if traced else contextlib.nullcontext():
            fn(image, u, psf, 2, 22, 2, 22, 1e9, iterations=3, blind=False, device="cpu")
        assert trl.loop_log[-1] == dict(route="host", outers=3, reads=3, k7w=None,
                                        capture_ms=None, instantiate_ms=None)
