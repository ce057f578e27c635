"""Wall-clock timing decorator (copy of ics_tpu/utils/timing.py; parity:
reference lib/utils.py:30-42)."""

from __future__ import annotations

import functools
import time

__all__ = ["timeit"]


def timeit(method):
    """Print ``'%r %2.2f sec'`` per call, like the reference decorator."""

    @functools.wraps(method)
    def timed(*args, **kw):
        ts = time.time()
        result = method(*args, **kw)
        te = time.time()
        print("%r %2.2f sec" % (method.__name__, te - ts))
        return result

    return timed
