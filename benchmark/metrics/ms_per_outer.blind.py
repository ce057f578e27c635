"""ms_per_outer.blind (inner loop and conv dispatch, ``ops/cuda_solver.py``,
``ops/conv.py``): the "solve (blind)" stage's milliseconds less its solves'
capture and instantiation milliseconds, over their outers, summed over the
traced window's frames."""

CASE, STAGE = "blind", "solve (blind)"


def read(record):
    ms = outers = 0.0
    for f in record["frames"]:
        if STAGE not in f.get("stages", {}) or len(f["solves"]) != len(f["levels"]):
            continue
        mine = [s for s, lv in zip(f["solves"], f["levels"]) if lv["case"] == CASE]
        ms += f["stages"][STAGE] * 1e3 - sum(
            (s.get("capture_ms") or 0.0) + (s.get("instantiate_ms") or 0.0) for s in mine)
        outers += sum(s["outers"] for s in mine)
    return ms / outers if outers else None
