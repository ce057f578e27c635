"""The stamped pass of a traced run, and what its readers compute from it.

The pass deblurs the traffic mix's pool in turn, each frame through
``deblur_module(trace=Tracer(sync=False))``, for whole passes of the pool,
at least one and at least ``SECONDS`` of frames.  Such a tracer synchronises
nothing: each stage and each WHILE solve opens a span with host times and,
on the card, stamps of %globaltimer on the current stream (K7w stamps each
of its runs), read once after the frame by ``Tracer.collect()`` and put on
the host's clock (``ics_tpu_torch/utils/trace.py``).  The frames run as the
window's do, the solves on the WHILE path.  Each frame's wall, spans and
solves (the solve spans' ``loop_log`` entries) go to ``record["stamped"]``.

``run_cell`` runs the pass in a ``--trace 1`` run, after the window and
before the profiled frame, and puts it in ``record["stamped"]``; its
metrics (``benchmark/metrics/``) read that key.  A pass that raises is not
caught: the traced run fails.  Without the key, and with a program that
has no stamping tracer, every such metric reads nothing.

On the card, between one span's closing stamp and the next span's opening
stamp in stream order no work was launched (every statement of
``deblur_module`` that launches device work lies in a stage, and a solve
launches nothing between 'outer 1' and its WHILE launch), so that time is
idle; the host span open during it names its cause.  The pass prints those
gaps, summed by that span, on standard error.
"""

from __future__ import annotations

import inspect
import statistics
import sys
import time
from collections import defaultdict

SECONDS = 10.0  # the least length of the pass
SOLVE_STAGES = {"solve (blind)": "blind", "solve (non-blind)": "non-blind"}


def frames(record: dict):
    """``record["stamped"]``, the pass's frames, or None."""
    return record.get("stamped")


def stamping(tracer_type) -> bool:
    """Whether the program's tracer has the stamping mode."""
    return ("sync" in inspect.signature(tracer_type).parameters
            and callable(getattr(tracer_type, "collect", None)))


def run_pass(cell, dev, seconds: float = SECONDS, pool=None):
    """The stamped pass on ``dev`` over ``pool`` (the mix's, made here
    without it): one entry per frame, or None where the program has no
    stamping tracer."""
    import torch

    from benchmark import scenes
    from benchmark.run import _program

    deblur, tracer_type, _ = _program()
    if not stamping(tracer_type):
        print("stamped pass: the program's tracer does not stamp; nothing read", file=sys.stderr)
        return None
    from ics_tpu_torch.utils import trace

    cuda = dev.type == "cuda"
    h, w, _ = cell.config["frame"]
    mix = cell.mix
    if pool is None:
        pool = scenes.pool(h, w, cell.config["kwargs"]["blur_width"],
                           mix["scene_seeds"][:mix["pool"]], dev, noise=mix["noise"],
                           blocks=mix["blocks"])
    cell.set_up()
    kw = cell.kwargs(dev)
    out = []
    t0 = time.perf_counter()
    while not out or len(out) % len(pool) or time.perf_counter() - t0 < seconds:
        scene = len(out) % len(pool)
        tracer = tracer_type(sync=False)
        before = tracer.calibrate(dev) if cuda else None
        s = time.perf_counter()
        deblur(pool[scene], "frame", None, trace=tracer, **kw)
        wall = time.perf_counter() - s
        spans = tracer.collect()
        after = tracer_type(sync=False).calibrate(dev) if cuda else None
        solves = list({id(s["info"]): s["info"] for s in spans if s["info"] is not None}.values())
        out.append(dict(scene=scene, wall_s=wall, spans=spans, solves=solves,
                        clock_err_ns=before[1] if cuda else None,
                        drift_ns=after[0] - before[0] if cuda else None))
    resolution = trace.timer_resolution_ns(dev) if cuda else None
    report(out, resolution)
    return out


def _by_id(frame):
    return {s["id"]: s for s in frame["spans"]}


def solves(frame, case: str):
    """(the 'while' span, the 'outer 1' span before it or None) of each
    WHILE solve of ``case`` ('blind' or 'non-blind') in ``frame``."""
    by_id, first, out = _by_id(frame), {}, []
    for s in frame["spans"]:
        parent = by_id.get(s["parent"])
        if parent is None or SOLVE_STAGES.get(parent["name"]) != case:
            continue
        if s["name"] == "outer 1":
            first[s["parent"]] = s
        elif s["name"] == "while":
            out.append((s, first.pop(s["parent"], None)))
    return out


def _bodies(w) -> int:
    return max(len(w.get("k7w") or ()) - 1, 0)


def while_body_ms(record, case: str):
    """Σ (last - first K7w stamp) over Σ bodies (K7w's runs - 1) of the
    ``case`` WHILE launches of the stamped frames, in ms."""
    ns = bodies = 0
    for f in frames(record) or ():
        for w, _ in solves(f, case):
            if _bodies(w):
                ns += w["k7w"][-1] - w["k7w"][0]
                bodies += _bodies(w)
    return ns * 1e-6 / bodies if bodies else None


def kernels_per_outer(record, case: str):
    """The kernel nodes of each ``case`` body, weighted by the bodies it
    ran, over the stamped frames."""
    kernels = bodies = 0
    for f in frames(record) or ():
        for w, _ in solves(f, case):
            nodes = (w["info"] or {}).get("body_nodes")
            if nodes and _bodies(w):
                kernels += nodes["kernel"] * _bodies(w)
                bodies += _bodies(w)
    return kernels / bodies if bodies else None


def capture_waits_ms(frame) -> list[float]:
    """Each WHILE solve's wait on the card for its capture, build and
    launch: its first K7w stamp less 'outer 1''s closing stamp, in ms."""
    return [(w["device"][0] - o["device"][1]) * 1e-6
            for case in SOLVE_STAGES.values() for w, o in solves(frame, case)
            if o is not None and o["device"] is not None and w["device"] is not None]


def capture_wait_ms(record):
    """Per stamped frame, the sum of its solves' waits; the median."""
    per = [sum(waits) for f in frames(record) or () if (waits := capture_waits_ms(f))]
    return statistics.median(per) if per else None


def gaps(frame) -> list[tuple[int, int]]:
    """The device's idle intervals of ``frame`` on the host's clock: from a
    span's closing stamp to the next span's opening stamp in stream order."""
    stamps = sorted((q, t, end) for s in frame["spans"] if s["seq"] is not None
                    for q, t, end in zip(s["seq"], s["device"], (False, True)))
    return [(a[1], max(a[1], b[1])) for a, b in zip(stamps, stamps[1:]) if a[2] and not b[2]]


def host_wait_pct(record):
    """Per stamped frame, 100 x its idle gaps over its device window (first
    to last stamp); the median."""
    per = []
    for f in frames(record) or ():
        times = [t for s in f["spans"] if s["device"] is not None for t in s["device"]]
        if len(times) > 1 and max(times) > min(times):
            idle = sum(b - a for a, b in gaps(f))
            per.append(100.0 * idle / (max(times) - min(times)))
    return statistics.median(per) if per else None


def gaps_by_span(frame) -> dict[str, float]:
    """The idle gaps of ``frame`` in ns, each part summed under the innermost
    host span open then ('(none)' outside every span)."""
    by_id = _by_id(frame)
    depth = {}
    for s in frame["spans"]:
        p, d = s["parent"], 0
        while p is not None:
            p, d = by_id[p]["parent"], d + 1
        depth[s["id"]] = d
    out = defaultdict(float)
    for a, b in gaps(frame):
        if b <= a:
            continue
        cuts = sorted({a, b, *(t for s in frame["spans"] for t in s["host"] if a < t < b)})
        for x, y in zip(cuts, cuts[1:]):
            mid = (x + y) / 2
            open_ = [s for s in frame["spans"] if s["host"][0] <= mid < s["host"][1]]
            name = max(open_, key=lambda s: depth[s["id"]])["name"] if open_ else "(none)"
            out[name] += y - x
    return dict(out)


def report(out, resolution) -> None:
    """The pass on standard error: walls, stages (host and device), the
    idle gaps by host span, capture waits, the clock."""
    if not out:
        return
    n = len(out)
    walls = [f["wall_s"] for f in out]
    print(f"stamped pass: {n} frames, wall median {statistics.median(walls):.4f} s, "
          f"walls {[round(x, 4) for x in walls]}", file=sys.stderr)
    host, device = defaultdict(float), defaultdict(float)
    for f in out:
        for s in f["spans"]:
            host[s["name"]] += (s["host"][1] - s["host"][0]) * 1e-6 / n
            if s["device"] is not None:
                device[s["name"]] += (s["device"][1] - s["device"][0]) * 1e-6 / n
    for name in sorted(host, key=lambda k: -host[k]):
        dev = f"{device[name]:.3f}" if name in device else "-"
        print(f"stamped span {name!r}: host {host[name]:.3f} ms, device {dev} ms a frame",
              file=sys.stderr)
    idle = defaultdict(float)
    for f in out:
        for name, ns in gaps_by_span(f).items():
            idle[name] += ns * 1e-6 / n
    print(f"stamped idle gaps by host span (ms a frame): "
          f"{ {k: round(v, 3) for k, v in sorted(idle.items(), key=lambda kv: -kv[1])} }",
          file=sys.stderr)
    waits = [sum(capture_waits_ms(f)) for f in out]
    print(f"stamped capture waits (ms a frame): {[round(x, 3) for x in waits]}", file=sys.stderr)
    if out[0]["clock_err_ns"] is not None:
        print(f"stamped clock: half-width {[f['clock_err_ns'] for f in out]} ns, drift over a "
              f"frame {[f['drift_ns'] for f in out]} ns; %globaltimer step (least, mean) "
              f"{resolution} ns", file=sys.stderr)
