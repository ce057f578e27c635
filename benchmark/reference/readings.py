"""The readings that the limits of ``correct`` are set from, at a cell's own
size, in one process on the GPU:

    python3 -m benchmark.reference.readings --workload cam24-exact.blind \
        --scenes 12 --control 3

The lower readings: the program (``deblur_module`` with the cell's kwargs,
the mix's set-up run first) on the traffic mix's scenes, the pool's first
and then further seeds of the same generator, each frame held against the
configuration's reference level by level as a benchmark run holds it.  The
upper readings: the control, the reference itself in the program's place
computed with TF32 on (the nearest precision below the configuration's
float32 with TF32 off), left to make its own stops, then held against the
reference in float32 the same way.  Prints one JSON line per frame, with
each level's numbers, and a summary line; the benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import scenes
from benchmark.run import Cell, _Levels, _program


def program_numbers(cell: Cell, frame, dev, detail: list | None = None) -> dict:
    deblur = _program()[0]
    levels = _Levels(keep=True)
    with contextlib.redirect_stdout(sys.stderr):
        got = deblur(frame, "frame", None, stats_out=levels, **cell.kwargs(dev))
    records = levels.records()
    del levels
    return cell.reference.run(frame, cell.kwargs(), dev, follow=records, program_codes=got,
                              detail=detail)


def control_numbers(cell: Cell, frame, dev, detail: list | None = None) -> dict:
    reference = cell.reference
    codes, records = reference.run(frame, cell.kwargs(), dev, tf32=True)
    records = [{**r, "u": r["u"].cpu(), "psf": None if r["psf"] is None else r["psf"].cpu(),
                "image": None if r["image"] is None else r["image"].cpu()} for r in records]
    return reference.run(frame, cell.kwargs(), dev, follow=records, program_codes=codes,
                         detail=detail)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--scenes", type=int, default=12, help="frames the program runs")
    parser.add_argument("--control", type=int, default=3, help="frames the control runs")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cell = Cell(args.workload, Path(__file__).resolve().parents[2])
    cell.set_up()
    dev = torch.device(args.device)
    h, w, _ = cell.config["frame"]
    mix = cell.mix
    seeds = list(mix["scene_seeds"][:mix["pool"]])
    seeds += [seeds[-1] + i for i in range(1, max(args.scenes, args.control) - len(seeds) + 1)]
    lower, upper = {}, {}
    for i, seed in enumerate(seeds):
        frame = scenes.make_scene(h, w, cell.config["kwargs"]["blur_width"], seed, dev,
                                  noise=mix["noise"], blocks=mix["blocks"])
        for side, count, fn, into in (("program", args.scenes, program_numbers, lower),
                                      ("control", args.control, control_numbers, upper)):
            if i < count:
                t, levels = time.perf_counter(), []
                found = fn(cell, frame, dev, levels)
                print(json.dumps(dict(side=side, scene_seed=seed, numbers=found,
                                      seconds=time.perf_counter() - t, levels=levels)),
                      flush=True)
                for k, v in found.items():
                    into.setdefault(k, []).append(v)
    print(json.dumps(dict(workload=args.workload,
                          lower={k: max(v) for k, v in lower.items()},
                          upper={k: min(v) for k, v in upper.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
