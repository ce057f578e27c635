"""setup_s: process start to the end of warm-up (import, the card's context,
the kernel library loaded or built, the scene pool made, the warm frames),
host clock."""


def read(record):
    return record["setup_s"]
