"""while_body_ms.nonblind (the solver's outer loop on the device, ``models/rl_mm.py``,
``ops/cuda_outer.py``, ``csrc/graph_while.cu``): one non-blind WHILE body's time on the
card, from K7w's stamps of its runs (``benchmark/stamped.py``): the sum of
(last - first stamp) over the sum of bodies (K7w's runs - 1), over the non-blind
WHILE launches of the stamped frames, in ms.  Nothing without a stamped pass."""

from benchmark import stamped


def read(record):
    return stamped.while_body_ms(record, "non-blind")
