"""k5_per_outer (TV stencil, ``csrc/tv.cu`` via ``ops/cuda_tv.py``, ``ops/tv.py``):
K5 launches per outer of the traced window's WHILE solves: each solve's
``body_launches["k5"]`` (K5's launches over the capture of one body, from
``rl_mm.loop_log``) times its outers (the bodies K7w ran, plus outer 1,
which runs the same body eagerly), over their outers.  Nothing on a record
without ``body_launches`` (a program that does not log them), without a
WHILE solve, or where no body launched K5 (a cell that does not list this
metric reads nothing, not 0)."""

KERNEL = "k5"


def read(record):
    launches = outers = 0
    for f in record["frames"]:
        for s in f.get("solves") or ():
            per_body = s.get("body_launches")
            if s.get("route") != "while" or not per_body or KERNEL not in per_body:
                continue
            launches += per_body[KERNEL] * s["outers"]
            outers += s["outers"]
    return launches / outers if launches else None
