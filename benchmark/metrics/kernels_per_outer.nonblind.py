"""kernels_per_outer.nonblind (inner loop and conv dispatch, ``ops/cuda_solver.py``,
``ops/conv.py``): the kernel nodes of each non-blind body as captured (the
solve's ``body_nodes``, counted from its graph), weighted by the bodies K7w
counted it run, over the stamped frames (``benchmark/stamped.py``).  Nothing
without a stamped pass."""

from benchmark import stamped


def read(record):
    return stamped.kernels_per_outer(record, "non-blind")
