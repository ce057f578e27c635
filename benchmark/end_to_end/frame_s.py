"""frame_s: the window's time, from its start to the end of its last frame,
over the frames completed (closed loop, one client), host clock."""


def read(record):
    done = sum(f["ok"] for f in record["frames"])
    return record["window_s"] / done if done else None
