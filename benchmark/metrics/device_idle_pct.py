"""device_idle_pct (device, the H100): DERIVED from two runs of the pool's
first scene, not traced in one: 100 x (1 - the device-busy seconds of the
frame profiled in the Python outer loop, its per-outer reads of the stop
state left out, over the wall of the same frame unprofiled in the WHILE
loop).  The two loops run the same kernels on the same shapes with the
same bits; the WHILE loop's own launches are not profiled (the port sends
every solve under a profiler to the Python loop)."""


def read(record):
    p = record.get("profile")
    if not p or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_while_s"])
