"""outers_per_frame (the solver's outer loop on the device): the outers of
a frame's solves, from ``rl_mm.loop_log`` (``outers``, which must equal the
runs K7w counted on the card where it counted them), the mean over the
traced window's frames."""


def read(record):
    per = []
    for f in record["frames"]:
        if not f.get("solves"):
            continue
        if any(s.get("k7w") not in (None, s["outers"]) and s["outers"] > 1 for s in f["solves"]):
            return None
        per.append(sum(s["outers"] for s in f["solves"]))
    return sum(per) / len(per) if per else None
