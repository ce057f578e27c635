"""capture_wait_ms (the solver's outer loop on the device, ``models/rl_mm.py``,
``ops/cuda_outer.py``, ``csrc/graph_while.cu``): the card's wait for each
solve's capture, WHILE build and launch, from the stamps of the stamped frames
(``benchmark/stamped.py``): K7w's first stamp less the closing stamp of
'outer 1', summed over a frame's solves, in ms; the median over the frames.
Nothing without a stamped pass."""

from benchmark import stamped


def read(record):
    return stamped.capture_wait_ms(record)
