"""k5_roofline (TV stencil, ``csrc/tv.cu`` via ``ops/cuda_tv.py``, ``ops/tv.py``):
the least time of every K5 launch of the profiled frame (``kernels/k5.py``,
``roofline.py``) over their device time, in percent.  The profiled frame
runs its solves in the Python outer loop (same kernels and bits as the
WHILE loop).  Nothing when the frame launched no K5, or when the launches
and the calls that the harness saw do not pair up (a program that calls K5
by another name than ``cuda_tv.tv_planar``)."""

KERNEL = "k5"


def read(record):
    k = record.get("profile", {}).get("kernels", {}).get(KERNEL)
    if not k or not k["launches"] or k["launches"] != k["calls"]:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
