"""host_wait_pct (device, the H100): per stamped frame (``benchmark/stamped.py``),
100 x the card's idle gaps, each from one span's closing stamp to the next
span's opening stamp in stream order (no work is launched between them), over
the frame's device window (first to last stamp); the median over the frames.
A measured lower bound of the WHILE path's idle share: idle time inside a span
is not counted.  Nothing without a stamped pass."""

from benchmark import stamped


def read(record):
    return stamped.host_wait_pct(record)
