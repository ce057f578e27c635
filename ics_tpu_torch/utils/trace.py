"""Tracing utilities (counterpart of ics_tpu/utils/trace.py): the stage
``Tracer``, the device trace ``profile_trace`` and ``block_and_time``.

``Tracer`` has two modes.

* ``Tracer()`` (``sync=True``, the default) times each stage on the host
  and synchronizes the device when the stage starts and when it ends: the
  time of a stage is the device work queued in it.  That serializes stages
  the untraced pipeline overlaps, so leave it off when timing end to end.
* ``Tracer(sync=False)`` synchronizes nothing.  Each span records its name,
  id, parent id, frame id, its host start and end (``time.perf_counter_ns``,
  CLOCK_MONOTONIC on Linux) and, on a CUDA device, a stamp of the card's
  %globaltimer where it opens and where it closes, launched on the current
  stream (``stamp``, csrc/stamp.cu).  Within a frame (``Tracer.frame``,
  which ``deblur_module`` opens around its work) the solvers' WHILE loop
  (models/rl_mm.py::_while_loop) finds the tracer (``active``) and opens
  its own spans, each carrying the solve's ``loop_log`` entry: 'outer 1'
  (host and device), 'capture' and 'build' (host only: nothing is stamped
  while a capture is open) and 'while' (the host's launch and read; on the
  device K7w's stamps, one per run, csrc/graph_while.cu).  Spans stay in
  memory until ``Tracer.collect()``, called after the frame's own last
  read, reads every stamp in one copy and returns the spans with their
  device times on the host's clock (``Tracer.calibrate``).

Every statement of ``deblur_module`` that launches device work lies inside
a stage, so on the device the time between one span's closing stamp and
the next span's opening stamp is idle, and the host span open then names
its cause.  torch.profiler's events are on CLOCK_REALTIME
(``profiler_offset_ns`` maps the tracer's clock onto it).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time

import torch

__all__ = ["Tracer", "active", "stamp", "timer_resolution_ns", "profiler_offset_ns",
           "profile_trace", "block_and_time"]

_ACTIVE = contextvars.ContextVar("ics_tpu_torch_tracer", default=None)
_CHUNK = 4096  # stamps per device buffer of a tracer


@dataclasses.dataclass
class _Stage:
    name: str
    seconds: float
    count: int


@dataclasses.dataclass
class _Span:
    name: str
    id: int
    parent: int | None
    frame: int
    host: list  # [start, end] ns, perf_counter_ns
    info: dict | None = None  # a solve's loop_log entry
    # [start, end] stamps, each (index into the tracer's buffers, order on
    # the stream), or None where a capture was open
    at: list | None = None
    k7w: torch.Tensor | None = None  # K7w's stamps of a WHILE launch
    seq: tuple | None = None  # K7w's first and last stamps' order on the stream


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def active():
    """The stamping tracer of the frame running in this context
    (``Tracer(sync=False).frame``), or None."""
    return _ACTIVE.get()


def stamp(buf: torch.Tensor, index: int, count: int = 1) -> None:
    """Write the card's %globaltimer (ns) into ``buf[index]``, or ``count``
    successive readings from one thread into ``buf[index:index + count]``,
    on the current stream of ``buf``'s device: one thread, one launch.
    CUDA only: a CPU tracer stamps nothing."""
    from ics_tpu_torch import _build

    if buf.device.type != "cuda" or buf.dtype != torch.int64 or buf.dim() != 1:
        raise ValueError(f"a stamp is written into a 1-d int64 CUDA tensor; got {buf.dtype} "
                         f"{tuple(buf.shape)} on {buf.device}")
    if not buf.is_contiguous() or not (0 <= index and 1 <= count <= buf.numel() - index):
        raise ValueError(f"stamps {index}..{index + count - 1} outside a buffer of {buf.numel()}")
    rc = _build.load_library().ics_stamp(buf.data_ptr(), int(index), int(count),
                                         torch.cuda.current_stream(buf.device).cuda_stream)
    _build.check(rc, "ics_stamp")


def timer_resolution_ns(device, reads: int = 4096) -> tuple[int, float]:
    """(the smallest nonzero step, the mean step) between ``reads``
    successive readings of the card's %globaltimer in one thread: the
    timer's resolution, or its read time where that is longer."""
    buf = torch.empty(reads, dtype=torch.int64, device=device)
    stamp(buf, 0, reads)
    steps = buf.diff().cpu()
    return int(steps[steps > 0].min()), float(steps.double().mean())


def profiler_offset_ns(pairs: int = 16) -> int:
    """CLOCK_REALTIME (``time.time_ns``, the clock of torch.profiler's
    events) less the tracer's clock, from the narrowest of ``pairs``
    readings."""
    best = None
    for _ in range(pairs):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


class Tracer:
    """Stage tracer: ``Tracer()`` synchronizes at each stage boundary and
    accumulates seconds; ``Tracer(sync=False)`` records spans with device
    stamps and synchronizes nothing (module docstring).

    >>> tracer = Tracer()
    >>> with tracer.stage("resize"):
    ...     ...
    >>> tracer.report()
    """

    def __init__(self, sync: bool = True):
        self.sync = sync
        self._stages: dict[str, _Stage] = {}
        self.device = None  # the CUDA device stamped (Tracer.frame)
        # (offset, half-width) in ns: host = device + offset (Tracer.calibrate)
        self.clock: tuple[int, int] | None = None
        self._spans: list[_Span] = []
        self._open: list[_Span] = []
        self._frame = 0
        self._ids = 0
        self._seq = 0  # device stamps launched, K7w's counted as two
        self._bufs: list[torch.Tensor] = []
        self._next = 0  # the next index into the stamp buffers

    @property
    def clock_err_ns(self) -> int | None:
        """The half-width of the device-to-host mapping, or None before it."""
        return None if self.clock is None else self.clock[1]

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.sync:
            _sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                _sync()
                self._add(name, time.perf_counter() - t0)
        else:
            with self.span(name) as s:
                yield
            self._add(name, (s.host[1] - s.host[0]) * 1e-9)

    def _add(self, name: str, dt: float) -> None:
        s = self._stages.get(name)
        if s is None:
            self._stages[name] = _Stage(name, dt, 1)
        else:
            s.seconds += dt
            s.count += 1

    @contextlib.contextmanager
    def frame(self, device=None):
        """One frame's work: with ``sync=False`` its spans share a frame id
        under a root span 'frame' (host only), stamp ``device`` where it is
        a CUDA device, and the solves inside find this tracer
        (``active``).  With ``sync=True`` nothing."""
        if self.sync:
            yield
            return
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            if self.device is not None and self.device != dev:
                raise ValueError(f"a tracer stamps one device: {self.device}, not {dev}")
            self.device = dev
        self._frame += 1
        token = _ACTIVE.set(self)
        try:
            with self.span("frame", device=False):
                yield
        finally:
            _ACTIVE.reset(token)

    @contextlib.contextmanager
    def span(self, name: str, info: dict | None = None, device: bool = True, k7w=None):
        """A span (``sync=False``): host times, and on the tracer's CUDA
        device a stamp at each end (``device``), or K7w's stamps ``k7w``
        (``k7w_stamps``) as its device times.  ``info``: a dict kept with
        the span (a solve's ``loop_log`` entry)."""
        self._ids += 1
        parent = self._open[-1].id if self._open else None
        s = _Span(name, self._ids, parent, self._frame, [None, None], info)
        self._spans.append(s)
        if k7w is not None:
            s.k7w, s.seq = k7w, (self._seq, self._seq + 1)
            self._seq += 2
        elif device and self.device is not None:
            s.at = [self._stamp(), None]
        self._open.append(s)
        ranged = (torch.profiler.record_function(name) if torch._C._autograd._profiler_enabled()
                  else contextlib.nullcontext())
        # the host times leave out the tracer's own stamp launches
        s.host[0] = time.perf_counter_ns()
        try:
            with ranged:
                yield s
        finally:
            s.host[1] = time.perf_counter_ns()
            self._open.pop()
            if s.at is not None:
                s.at[1] = self._stamp()

    def _stamp(self):
        """Launch one stamp on the current stream: its (buffer index, order
        on the stream), or None while a capture is open."""
        if torch.cuda.is_current_stream_capturing():
            return None
        chunk, at = divmod(self._next, _CHUNK)
        if chunk == len(self._bufs):
            self._bufs.append(torch.empty(_CHUNK, dtype=torch.int64, device=self.device))
        stamp(self._bufs[chunk], at)
        self._next += 1
        self._seq += 1
        return (self._next - 1, self._seq - 1)

    def k7w_stamps(self, runs: int, device):
        """A zeroed int64 buffer on ``device`` for K7w's stamps of one WHILE
        launch of at most ``runs`` runs, or None where this tracer stamps
        no such device."""
        if self.device is None or torch.device(device) != self.device:
            return None
        return torch.zeros(runs, dtype=torch.int64, device=device)

    def calibrate(self, device=None, pairs: int = 16) -> tuple[int, int]:
        """Map the card's %globaltimer onto the host's clock: ``pairs`` times
        (host before a stamp's launch, the stamp, host after its sync); the
        narrowest pair gives host = device + offset within its half-width.
        Sets and returns ``clock`` (offset, half-width) in ns."""
        dev = torch.device(device) if device is not None else self.device
        if dev is None or dev.type != "cuda":
            raise ValueError(f"calibration needs a CUDA device; got {dev}")
        buf = torch.empty(pairs, dtype=torch.int64, device=dev)
        torch.cuda.synchronize(dev)
        hosts = []
        for i in range(pairs):
            t0 = time.perf_counter_ns()
            stamp(buf, i)
            torch.cuda.synchronize(dev)
            hosts.append((t0, time.perf_counter_ns()))
        stamps = buf.tolist()
        i = min(range(pairs), key=lambda k: hosts[k][1] - hosts[k][0])
        t0, t1 = hosts[i]
        self.clock = ((t0 + t1) // 2 - stamps[i], (t1 - t0 + 1) // 2)
        return self.clock

    def collect(self) -> list[dict]:
        """The spans recorded since the last collect, in the order they
        opened, as dicts: name, id, parent, frame, host (start, end) in ns,
        device (start, end) on the host's clock or None, seq (the two
        device times' order on the stream) or None, info (the solve's
        ``loop_log`` entry) or None, and for a WHILE launch ``k7w``, every
        stamp of K7w's runs.  Reads every stamp in one copy to the host,
        after the frame's work; calibrates the clock first if it was not.
        Call it with no span open."""
        if self._open:
            raise RuntimeError(f"collect() with spans open: {[s.name for s in self._open]}")
        spans, self._spans = self._spans, []
        k7w = [s.k7w for s in spans if s.k7w is not None]
        values = []
        if self._next or k7w:
            if self.clock is None:
                self.calibrate()
            used = self._bufs[: -(-self._next // _CHUNK)]
            if used:
                used[-1] = used[-1][: self._next - _CHUNK * (len(used) - 1)]
            values = torch.cat(used + k7w).cpu().tolist()
        offset = self.clock[0] if self.clock is not None else 0
        base = self._next
        self._next = 0
        out = []
        for s in spans:
            d = dict(name=s.name, id=s.id, parent=s.parent, frame=s.frame, host=tuple(s.host),
                     device=None, seq=None, info=s.info)
            if s.at is not None and None not in s.at:
                d["device"] = tuple(values[i] + offset for i, _ in s.at)
                d["seq"] = tuple(q for _, q in s.at)
            elif s.k7w is not None:
                runs = [v + offset for v in values[base: base + s.k7w.numel()] if v != 0]
                base += s.k7w.numel()
                d["k7w"] = runs
                if runs:
                    d["device"], d["seq"] = (runs[0], runs[-1]), s.seq
            out.append(d)
        return out

    def report(self, out=None) -> str:
        lines = [
            f"{s.name:<24} {s.seconds:8.3f}s  ({s.count}×)"
            for s in sorted(self._stages.values(), key=lambda s: -s.seconds)
        ]
        text = "\n".join(lines)
        if out is not None:
            print(text, file=out)
        return text


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block, the CPU's activity
    and, where a GPU is present, CUDA's, written under ``logdir`` as a
    TensorBoard trace file (``*.pt.trace.json``, as the JAX package writes
    its device trace for TensorBoard).  Solves in the block run the WHILE
    graph's captured body outer by outer in the host loop, as every solve
    under the profiler does (models/rl_mm.py::_eager_loop): the same
    kernels, K7 and the state's copies among them, and the same bits, with
    one read of the stop state per outer and no K7w."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def _devices(out, seen: set) -> set:
    """The devices of every tensor in ``out`` (nested sequences, dicts and
    dataclasses)."""
    if isinstance(out, torch.Tensor):
        seen.add(out.device)
    elif isinstance(out, (list, tuple)):
        for x in out:
            _devices(x, seen)
    elif isinstance(out, dict):
        for x in out.values():
            _devices(x, seen)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _devices(getattr(out, f.name), seen)
    return seen


def block_and_time(fn, *args, **kwargs):
    """Run fn, wait for the device of every tensor it returns, return
    (result, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for dev in _devices(out, set()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0
