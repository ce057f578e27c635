"""k2_roofline (kernels, ``csrc/inner_loop.cu`` via ``ops/cuda_solver.py``):
the least time of every K2 launch of the profiled frame (``kernels/k2.py``,
``roofline.py``) over their device time, in percent.  The profiled frame
runs its solves in the Python outer loop (same kernels and bits as the
WHILE loop).  Nothing when the launches and the calls do not pair up."""

KERNEL = "k2"


def read(record):
    k = record.get("profile", {}).get("kernels", {}).get(KERNEL)
    if not k or not k["launches"] or k["launches"] != k["calls"]:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
