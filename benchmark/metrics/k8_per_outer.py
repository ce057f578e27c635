"""k8_per_outer (the MM step, ``csrc/mm_step.cu`` via ``ops/cuda_step.py``):
K8 launches per outer of the traced window's WHILE solves: each solve's
``body_launches["k8"]`` (K8's launches over the capture of one body, two a
step, from ``rl_mm.loop_log``) times its outers (the bodies K7w ran, plus
outer 1, which runs the same body eagerly), over their outers.  Nothing on
a record without ``body_launches`` (a program that does not log them),
without a WHILE solve, or where no body launched K8 (a program without K8
reads nothing, not 0)."""

KERNEL = "k8"


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
