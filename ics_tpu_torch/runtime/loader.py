"""ctypes bindings of the native thread-pool file prefetcher
(``src/loader.cpp``).

Copied from ics_tpu/runtime/loader.py, with the same ``Prefetcher`` API;
the library is built at first use (``runtime/_lib.py``).  Background
threads read files into memory, so that the disk I/O of the next image
overlaps the decode of the current one.  Consumed by
``ics_tpu_torch.utils.io.imread_sequence`` and usable around any per-image
loop::

    with Prefetcher() as p:
        tickets = [p.submit(path) for path in paths]
        for t in tickets:
            data = p.take(t)   # blocks only if the read hasn't finished

``available()`` is ``False`` only on a host without a C++ compiler.
"""

from __future__ import annotations

import ctypes
import os
import time

from ics_tpu_torch.runtime import _lib

__all__ = ["available", "Prefetcher"]


def available() -> bool:
    return _lib.load() is not None


class Prefetcher:
    """Thread-pool file reader.  ``submit`` queues a path and returns a
    ticket; ``take`` returns the file's bytes, blocking only while the
    background read is still in flight."""

    def __init__(self, n_threads: int = 4):
        lib = _lib.load()
        if lib is None:
            raise RuntimeError("the native runtime needs a C++ compiler (set CXX)")
        self._lib = lib
        self._handle = lib.ics_loader_create(int(n_threads))

    def submit(self, path: str) -> int:
        ticket = self._lib.ics_loader_submit(self._handle, os.fspath(path).encode())
        if ticket < 0:
            raise RuntimeError(f"prefetch submit failed for {path!r}")
        return ticket

    def ready(self, ticket: int) -> bool:
        """True once the read finished (successfully or not)."""
        return self._lib.ics_loader_size(self._handle, ticket) != -1

    def take(self, ticket: int) -> bytearray:
        """The file's bytes, copied once, from the reader's buffer into a
        ``bytearray`` of the file's size (JAX's binding copies twice more)."""
        # Poll the size until the read lands so the copy buffer is exact:
        # the C take() blocks too, but it copies at most ``cap`` bytes and
        # erases the job, so a guessed cap could truncate.
        size = self._lib.ics_loader_size(self._handle, ticket)
        while size == -1:  # still pending
            time.sleep(0.0005)
            size = self._lib.ics_loader_size(self._handle, ticket)
        if size < 0:  # read error; drop the job slot
            self._lib.ics_loader_take(self._handle, ticket, ctypes.create_string_buffer(1), 1)
            raise OSError(f"prefetched read failed (ticket {ticket})")
        out = bytearray(int(size) or 1)
        view = (ctypes.c_char * len(out)).from_buffer(out)
        n = self._lib.ics_loader_take(self._handle, ticket, view, size)
        del view  # releases the buffer, so that it can shrink
        if n < 0:
            raise OSError(f"prefetched read failed (ticket {ticket})")
        del out[n:]
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.ics_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass
