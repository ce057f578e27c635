"""pre_post_ms (pipeline, ``models/pipeline.py::deblur_module``): the
"upload + preprocess" and "postprocess + download" stages of a frame,
together, the median over the traced window's frames.  Stage spans
synchronise the device at both ends."""

import numpy as np

STAGES = ("upload + preprocess", "postprocess + download")


def read(record):
    per = [sum(f["stages"].get(s, 0.0) for s in STAGES) * 1e3
           for f in record["frames"] if "stages" in f]
    return float(np.median(per)) if per else None
