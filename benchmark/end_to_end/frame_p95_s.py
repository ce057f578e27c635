"""frame_p95_s: the 95th percentile of every frame's wall in the window
(numpy's linear interpolation), host clock."""

import numpy as np


def read(record):
    walls = [f["wall_s"] for f in record["frames"] if f["ok"]]
    return float(np.percentile(walls, 95)) if walls else None
