"""Tracing utilities (counterpart of ics_tpu/utils/trace.py): the per-stage
wall-clock ``Tracer``, the device trace ``profile_trace`` and
``block_and_time``.

CUDA runs asynchronously, so each stage synchronizes the device when it
starts and when it ends: the time of a stage is the device work queued in
it.  That serializes stages the untraced pipeline overlaps, so leave tracing
off when timing end to end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

__all__ = ["Tracer", "profile_trace", "block_and_time"]


@dataclasses.dataclass
class _Stage:
    name: str
    seconds: float
    count: int


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Tracer:
    """Accumulating wall-clock tracer for pipeline stages.

    >>> tracer = Tracer()
    >>> with tracer.stage("resize"):
    ...     ...
    >>> tracer.report()
    """

    def __init__(self):
        self._stages: dict[str, _Stage] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            dt = time.perf_counter() - t0
            s = self._stages.get(name)
            if s is None:
                self._stages[name] = _Stage(name, dt, 1)
            else:
                s.seconds += dt
                s.count += 1

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
    its device trace for TensorBoard).  Solves in the block take the Python
    outer loop, with the same kernels and bits, as every solve under the
    profiler does (models/rl_mm.py::_eager_loop)."""
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
