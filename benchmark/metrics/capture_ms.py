"""capture_ms (the solver's outer loop on the device, ``models/rl_mm.py``,
``ops/cuda_outer.py``, ``csrc/graph_while.cu``): host milliseconds of a
frame's body captures and WHILE-graph builds and instantiations, from
``rl_mm.loop_log`` (``capture_ms`` + ``instantiate_ms``, summed over the
frame's solves), the median over the traced window's frames."""

import numpy as np


def read(record):
    per = [sum((s.get("capture_ms") or 0.0) + (s.get("instantiate_ms") or 0.0)
               for s in f["solves"])
           for f in record["frames"] if f.get("solves")]
    return float(np.median(per)) if per else None
