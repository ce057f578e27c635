"""The reduction of one profiled frame's ``torch.profiler`` events, in
memory and from the profiler's raw event list: the device's busy seconds,
the device operations that took most time, the longest idle gaps by what
the host was doing, and each kernel's launches beside the calls that
launched them.

Under the profiler the port runs every solve in its Python outer loop
(``rl_mm._eager_loop``: WHILE launches are not profiled), with the same
kernels and bits as the WHILE loop, plus one small device-to-host read of
the stop state per outer.  Those reads are left out of the busy time: of
the device-to-host copies only the largest, the frame's result, counts.
"""

from __future__ import annotations

import bisect

import torch

TOP = 10  # entries of each breakdown list
LABELLED_GAPS = 500  # the longest gaps whose host activity is looked up
DEVICE, RANGE, HOST = "device", "range", "host"  # kernels, copies and sets; named ranges; the rest


def _span_ns(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000


def _merge(spans):
    merged = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def reduce(prof, frame_range: str, stages, kernel_calls: dict) -> dict:
    """``frame_range``: the name of the ``record_function`` range around the
    profiled frame; ``stages``: the names of the stage ranges inside it (a
    range shows on the device too, under the same name).  ``kernel_calls``:
    per kernel name, (trace name fragment, [bound seconds of each call, in
    launch order]).  Times in seconds."""
    cpu = torch.autograd.DeviceType.CPU
    named = {frame_range, *stages}
    events = []
    for e in prof.profiler.kineto_results.events():
        name, on_host = e.name(), e.device_type() == cpu
        if name in named and not on_host:
            continue  # a range's span on the device: not device work
        events.append((name, RANGE if name in named else HOST if on_host else DEVICE,
                       *_span_ns(e)))
    f0, f1 = next((s, t) for n, a, s, t in events if n == frame_range)
    device = sorted(e for e in events if e[1] == DEVICE and f0 <= e[2] <= f1)
    copies = [e for e in device if "Memcpy DtoH" in e[0]]
    result = max(copies, key=lambda e: e[3] - e[2], default=None)
    work = [e for e in device if "Memcpy DtoH" not in e[0] or e is result]
    busy = _merge((s, t) for _, _, s, t in work)

    by_name: dict[str, float] = {}
    for name, _, s, t in work:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e9
    device_ops = sorted(([n[:160], v] for n, v in by_name.items()), key=lambda x: -x[1])[:TOP]

    edges = [f0] + [x for span in busy for x in span] + [f1]
    gaps = sorted(((edges[i + 1] - edges[i], (edges[i] + edges[i + 1]) // 2)
                   for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]),
                  reverse=True)
    ranges = [e for e in events if e[1] == RANGE and e[0] != frame_range]
    host = sorted(e for e in events if e[1] == HOST)
    starts = [e[2] for e in host]
    idle: dict[str, float] = {}
    for length, mid in gaps[:LABELLED_GAPS]:
        label = _host_activity(ranges, host, starts, mid)
        idle[label] = idle.get(label, 0.0) + length / 1e9
    idle_gaps = sorted(([n, v] for n, v in idle.items()), key=lambda x: -x[1])[:TOP]

    kernels = {}
    for name, (fragment, bounds) in kernel_calls.items():
        launched = [e for e in device if fragment in e[0]]
        kernels[name] = dict(calls=len(bounds), launches=len(launched),
                             device_s=sum(t - s for _, _, s, t in launched) / 1e9,
                             bound_s=sum(bounds))
    return dict(busy_s=sum(t - s for s, t in busy) / 1e9, window_s=(f1 - f0) / 1e9,
                device_ops=device_ops, idle_gaps=idle_gaps, kernels=kernels)


def _host_activity(ranges, host, starts, at, look_back: int = 2000) -> str:
    """What the host ran at ``at`` (ns): the pipeline stage's range, then
    the innermost host operation covering it, 'stage / op'."""
    stage = next((n for n, _, s, t in ranges if s <= at <= t), "outside the stages")
    hi = bisect.bisect_right(starts, at)
    inner = None
    for i in range(hi - 1, max(hi - look_back, 0) - 1, -1):
        name, _, s, t = host[i]
        if t >= at and (inner is None or t - s < inner[1]):
            inner = (name, t - s)
    return f"{stage} / {inner[0][:100] if inner else 'no host operation'}"
