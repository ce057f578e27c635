"""Per-stage wall-clock tracer (counterpart of ics_tpu/utils/trace.py).

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

__all__ = ["Tracer"]


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
