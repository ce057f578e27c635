"""resize_ms (resize, ``utils/resize.py``): the "resize + pad" stage of a
frame, every level's, the median over the traced window's frames."""

import numpy as np


def read(record):
    per = [f["stages"]["resize + pad"] * 1e3 for f in record["frames"]
           if "resize + pad" in f.get("stages", {})]
    return float(np.median(per)) if per else None
