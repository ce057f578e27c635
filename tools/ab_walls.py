#!/usr/bin/env python3
"""Wall time of the port's ``deblur_module`` on the 1.9 MP and 24 MP exact
cases, for two checkouts timed in turns on one GPU.

    python3 tools/ab_walls.py OLD_TREE NEW_TREE [--runs 3]

Each checkout runs in a process of its own (each builds its own kernels),
in the order old, new, new, old.  A process warms up once per case, then
prints one JSON line per timed run: the tree, the case, the wall seconds
(host clock around a call that ends in ``torch.cuda.synchronize()``) and
the outer iterations of each pyramid level.  The scenes are
``chip_smoke.make_scene``'s, with ``chip_smoke.py``'s phase 4 and 5 kwargs.
Needs a CUDA GPU; imports neither JAX nor ``ics_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

KW19 = dict(blur_width=7, mask=[584, 795], display=False, tolerance=0.1, quality="normal",
            preview=False, blur="static", iterations=200, verbose=False, precision="exact")
KW24 = dict(blur_width=9, mask=[2000, 3000], mask_size=511, display=False, tolerance=0.1,
            quality="normal", preview=False, blur="static", iterations=200, verbose=False,
            precision="exact")


def worker(tree: str, tag: str, runs: int) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    from ics_tpu_torch import deblur_module
    from ics_tpu_torch._device import exact_f32

    exact_f32()

    def run(pic, kw):
        stats = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            deblur_module(pic, "ab", None, stats_out=stats, device="cuda", **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, [s["result"].iterations for s in stats]

    for case, (h, w, blur, seed), kw in [("1.9MP", (1367, 1394, 7, 19), KW19),
                                         ("24MP", (4000, 6000, 9, 24), KW24)]:
        pic = chip_smoke.make_scene(h, w, blur, seed=seed)[1]
        run(pic, kw)  # warm-up
        for _ in range(runs):
            wall, outers = run(pic, kw)
            print(json.dumps({"tree": tag, "case": case, "wall_s": wall, "outers": outers}),
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "TAG"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(os.path.abspath(args.worker[0]), args.worker[1], args.runs)
        return 0
    for tag in ("old", "new", "new", "old"):
        tree = os.path.abspath(getattr(args, tag))
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), args.old, args.new,
                             "--runs", str(args.runs), "--worker", tree, tag], cwd=tree).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
