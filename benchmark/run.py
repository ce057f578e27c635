"""Run one cell of ``BENCHMARK.json`` on the GPU and print its result line.

    python3 -m benchmark.run --workload cam24-exact.blind --seed 7 --seconds 40 --trace 0

Set-up makes the traffic mix's pool of frames on the card, runs the mix's
own set-up where it has one (``traffic/<mix>.py``), loads the port's
kernels (built into ``ics_tpu_torch/_build/`` at a checkout's first run)
and deblurs the mix's warm-up frames.  The window then sends one raw
8-bit frame at a time to ``ics_tpu_torch.models.pipeline.deblur_module``,
the next when the last has come back as a 16-bit array on the host, until
``--seconds`` have passed; a frame begun before then finishes and counts.
With ``--trace 1`` every frame of the window runs with stage spans; then
the pool runs in the stamped pass (``stamped.py``), and its first scene
once more unprofiled and once under torch.profiler.

Once the window has closed, frames drawn from the seed are held against the
configuration's plain reference (``reference/plain.py`` unless it names
another), and the numbers compared are printed beside their limits: last
on standard error, and last in the result, the last line of standard
output.  A checked frame's levels are copied to the host as each level
ends; those copies, and the reading of each frame's stats and solve log,
are timed apart and left out of the window and of the frame's wall.
Without a CUDA device, or with JAX loaded, the run exits 1 and prints no
result.
"""

from __future__ import annotations

import time

_START = time.time()  # the process's start, as near as the interpreter sees it

import argparse  # noqa: E402
import atexit  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ics_tpu")  # top-level module names, compared whole
FRAME_RANGE = "benchmark.frame"


def _caches(root: Path) -> None:
    """Kernel caches inside the checkout, at fixed paths (the port's own
    build directory is ``ics_tpu_torch/_build/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(root / ".bench_cache" / sub)


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark_part_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic mix,
    plain reference, limits, metrics and kernel counts, each found by name
    under ``benchmark/``: the reference is ``reference/<name>.py`` for the
    configuration's ``"reference"`` key (``plain`` without one); a mix
    ``traffic/<mix>.json`` may have a set-up ``traffic/<mix>.py`` beside it,
    whose ``prepare(cell, directory)`` returns kwargs that every frame adds
    to the configuration's (``set_up``); the limits are the configuration's,
    with ``cells/<cell>.json``'s ``"limits"`` over them key by key where the
    cell has that file (a null there: the number is not compared)."""

    def __init__(self, name: str, root: Path):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.name, self.chips = name, cells[name]["chips"]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads((root / configs[cells[name]["config"]]["file"]).read_text())
        here = root / "benchmark"
        traffic = here / "traffic" / cells[name]["traffic"]
        self.mix = json.loads(traffic.with_suffix(".json").read_text())
        prepare = traffic.with_suffix(".py")
        self._prepare = _load(prepare).prepare if prepare.is_file() else None
        self.added: dict | None = None if self._prepare else {}
        reference = self.config.get("reference", "plain")
        self.reference = _load(here / "reference" / f"{reference}.py")
        own = here / "cells" / f"{name}.json"
        own = json.loads(own.read_text())["limits"] if own.is_file() else {}
        self.limits = {k: v for k, v in dict(self.config["limits"], **own).items()
                       if v is not None}
        mine = lambda m: name in m.get("workloads", [name])
        self.end_to_end = [(m, _load(here / "end_to_end" / f"{m['name']}.py"))
                           for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [(m, _load(here / "metrics" / f"{m['name']}.py"))
                          for m in bench["per_layer"] if mine(m)]
        self.kernels = {p.stem: _load(p) for p in sorted((here / "kernels").glob("*.py"))}

    def set_up(self) -> dict:
        """Run the mix's set-up once, in a directory of its own under
        ``TMPDIR`` that is removed at exit; returns the kwargs it added."""
        if self.added is None:
            directory = tempfile.mkdtemp(prefix="bench-mix-")
            atexit.register(shutil.rmtree, directory, True)
            self.added = dict(self._prepare(self, Path(directory)))
        return self.added

    def kwargs(self, device=None) -> dict:
        """A frame's kwargs: the configuration's with what the mix's set-up
        added, as the reference takes them; with ``device``, as the program
        does (``verbose=False`` and the device added)."""
        if self.added is None:
            raise RuntimeError(f"{self.name}: the mix's set-up has not run (Cell.set_up)")
        kw = dict(self.config["kwargs"], **self.added)
        return kw if device is None else dict(kw, verbose=False, device=str(device))


def _stages(tracer_type, timed: bool):
    """A tracer of the pipeline's stage spans (``deblur_module(trace=...)``
    opens one around each stage), each span also a ``record_function``
    range, which a profiler sees.  ``timed``: the port's ``Tracer`` times
    the stage, synchronising the device at both ends; otherwise the range
    alone, with no synchronisation (the profiled frame)."""
    import torch

    class _BenchTracer(tracer_type):
        def __init__(self):
            super().__init__()
            self.names: set[str] = set()  # every stage opened, timed or not

        @contextlib.contextmanager
        def stage(self, name):
            self.names.add(name)
            with torch.profiler.record_function(name), (
                    super().stage(name) if timed else contextlib.nullcontext()):
                yield

        @property
        def seconds(self) -> dict[str, float]:
            return {name: s.seconds for name, s in self._stages.items()}

    return _BenchTracer()


class _Levels(list):
    """``deblur_module(stats_out=...)``: of each level it keeps the case, the
    scale and the solver's stats, and with ``keep`` the outputs that the
    reference compares (the blind window, PSF and observed window, the
    non-blind frame), copied to the host as each level ends, so that the
    frame holds no more device memory than it would.  ``held_s``: the
    seconds those copies took, which are the check's and not the frame's."""

    def __init__(self, keep: bool):
        super().__init__()
        self.keep, self.held_s = keep, 0.0

    def append(self, entry):
        r, blind = entry["result"], entry["case"] == "blind"
        level = dict(case=entry["case"], scale=entry["scale"], stats=r.stats)
        if self.keep:
            import torch

            if r.u.is_cuda:
                torch.cuda.synchronize(r.u.device)  # the level's own work stays the frame's
            t = time.perf_counter()
            level.update(u=(r.u_full if blind else r.u).cpu(), psf=r.psf.cpu() if blind else None,
                         image=r.image.cpu() if blind else None, stats=r.stats.cpu())
            self.held_s += time.perf_counter() - t
        super().append(level)

    def records(self) -> list[dict]:
        """The levels on the host: outers, converged and M_r from the stats,
        and the kept tensors."""
        out = []
        for level in self:
            outers, converged, m_r = level["stats"].cpu().tolist()[:3]
            rec = dict(case=level["case"], scale=level["scale"], outers=int(outers),
                       converged=bool(converged), m_r=float(m_r))
            for key in ("u", "psf", "image"):
                if key in level:
                    rec[key] = level[key]
            out.append(rec)
        return out


def _program():
    """The port's public entry, its stage tracer and its solve log."""
    from ics_tpu_torch.models import rl_mm
    from ics_tpu_torch.models.pipeline import deblur_module
    from ics_tpu_torch.utils.trace import Tracer

    return deblur_module, Tracer, rl_mm.loop_log


def _plan(cell: Cell, seed: int):
    """The frames' order, the pool in turn from its first scene, the same
    for every seed: the pool's scenes differ in their outers, and a window
    holds few 24 MP frames, so an order drawn from the seed would change
    the work with it.  The window's frames that the reference checks are
    drawn from the seed."""
    check = cell.config["check"]
    chosen = random.Random(seed).sample(range(check["among_first"]), check["frames"])
    return list(range(cell.mix["pool"])), set(chosen)


@contextlib.contextmanager
def _counting(cell: Cell, bounds: dict):
    """Within the block each kernel file's wrapper records the least time of
    each call that launches its kernel (a call on CUDA tensors)."""
    from benchmark.roofline import bound_s

    saved = []
    for name, spec in cell.kernels.items():
        module = importlib.import_module(spec.CALL[0])
        original = getattr(module, spec.CALL[1])
        bounds[name] = (spec.NAME, [])

        def counted(*args, _f=original, _spec=spec, _into=bounds[name][1], **kw):
            if args[0].is_cuda:
                _into.append(bound_s(*_spec.work(*args, **kw), _spec.KIND))
            return _f(*args, **kw)

        saved.append((module, spec.CALL[1], original))
        setattr(module, spec.CALL[1], counted)
    try:
        yield
    finally:
        for module, attr, original in saved:
            setattr(module, attr, original)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             start: float | None = None) -> dict:
    """Set-up, the window, the profiled frame (``trace``) and the check;
    returns the result's fields and the record the metric readers read."""
    import torch

    from benchmark import scenes, stamped

    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    deblur, tracer_type, loop_log = _program()
    h, w, _ = cell.config["frame"]
    mix = cell.mix
    t_pool = time.time()
    frames = scenes.pool(h, w, cell.config["kwargs"]["blur_width"],
                         mix["scene_seeds"][:mix["pool"]], dev, noise=mix["noise"],
                         blocks=mix["blocks"])
    order, check = _plan(cell, seed)
    t_mix = time.time()
    cell.set_up()
    kw = cell.kwargs(dev)
    t_warm = time.time()
    for _ in range(mix["warm_frames"]):
        deblur(frames[0], "frame", None, **kw)
    sync()
    t_end = time.time()
    start = start if start is not None else _START
    record = dict(setup_s=t_end - start, frames=[])
    print(f"set-up {t_end - start:.3f} s: to the pool {t_pool - start:.3f} s (imports, the "
          f"card's context), the pool {t_mix - t_pool:.3f} s, the mix's set-up "
          f"{t_warm - t_mix:.3f} s, the warm frames {t_end - t_warm:.3f} s (the kernels' "
          f"library loaded or built)", file=sys.stderr)

    kept, failed, out, levels = {}, 0, None, None
    # held: the window's seconds that serve the check and the record, not
    # the frames (the kept levels' copies, reading the stats and the log)
    t0 = time.perf_counter()
    end, held = t0, 0.0
    while end - t0 - held < seconds:
        i = len(record["frames"])
        scene = order[i % len(order)]
        levels = _Levels(keep=i in check) if (trace or i in check) else None
        stages = _stages(tracer_type, timed=True) if trace else None
        loop_log.clear()
        s = time.perf_counter()
        try:
            out = deblur(frames[scene], "frame", None, stats_out=levels,
                         trace=stages if stages else False, **kw)
        except Exception:  # a frame that raises never comes back: it counts as failed
            traceback.print_exc()
            failed, out = failed + 1, None
        end = time.perf_counter()
        copies = levels.held_s if levels is not None else 0.0
        entry = dict(scene=scene, wall_s=end - s - copies, ok=out is not None,
                     outers=sum(e["outers"] for e in loop_log))
        if levels is not None and out is not None:
            records = levels.records()
            if trace:
                entry.update(stages=stages.seconds, solves=[dict(e) for e in loop_log],
                             levels=[dict(case=r["case"], outers=r["outers"]) for r in records])
            if i in check:
                kept[i] = (scene, out, records)
        record["frames"].append(entry)
        held += copies + time.perf_counter() - end
        end = time.perf_counter()
    record["window_s"] = end - t0 - held
    _report_frames(record["frames"])
    record["memory_reserved_peak_bytes"] = (torch.cuda.max_memory_reserved(dev)
                                            if dev.type == "cuda" else None)

    if trace:  # the stamped pass (a pool's pass on the CPU), then the profiled frame
        record["stamped"] = stamped.run_pass(
            cell, dev, stamped.SECONDS if dev.type == "cuda" else 0.0, pool=frames)
        record["profile"] = _profile(cell, deblur, tracer_type, frames[0], kw, dev, sync)

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        raise RuntimeError(f"modules loaded in the benchmark's process: {loaded}")

    numbers = dict.fromkeys(cell.reference.NUMBERS, 0.0)
    del out, levels
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for i, (scene, got, records) in sorted(kept.items()):
        t = time.perf_counter()
        found = cell.reference.run(frames[scene], cell.kwargs(), dev, follow=records,
                                   program_codes=got)
        numbers = {k: max(numbers[k], v) for k, v in found.items()}
        print(f"checked frame {i} (scene {scene}, {sum(r['outers'] for r in records)} outers) "
              f"in {time.perf_counter() - t:.1f} s: {json.dumps(found)}", file=sys.stderr)
    limits = cell.limits
    checks = {k: dict(value=numbers[k], limit=limits[k]) for k in limits}
    correct = (bool(kept) and failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return dict(correct=correct, attempted=len(record["frames"]), failed=failed,
                record=record, checks=checks, checked=sorted(kept),
                unchecked={k: v for k, v in numbers.items() if k not in limits})


def _report_frames(frames) -> None:
    """Per scene of the pool, on standard error: its frames, their median
    and largest wall, and the outers of its frames."""
    import numpy as np

    print(f"the first frames' walls: {[round(f['wall_s'], 4) for f in frames[:4]]}",
          file=sys.stderr)
    for scene in sorted({f["scene"] for f in frames if f["ok"]}):
        mine = [f for f in frames if f["scene"] == scene and f["ok"]]
        walls = [f["wall_s"] for f in mine]
        print(f"scene {scene}: {len(mine)} frames, wall median {np.median(walls):.4f} s, "
              f"largest {max(walls):.4f} s, outers {sorted({f['outers'] for f in mine})}",
              file=sys.stderr)


def _profile(cell, deblur, tracer_type, frame, kw, dev, sync) -> dict:
    """The pool's first scene once unprofiled (the WHILE loop), then once
    under torch.profiler (the Python loop), with stage ranges and each
    kernel file's calls counted; the events are reduced in memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import devtrace

    s = time.perf_counter()
    deblur(frame, "frame", None, **kw)
    sync()
    wall_while = time.perf_counter() - s
    bounds: dict = {}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    stages = _stages(tracer_type, timed=False)
    with _counting(cell, bounds), profile(activities=activities) as prof:
        with torch.profiler.record_function(FRAME_RANGE):
            deblur(frame, "frame", None, trace=stages, **kw)
            sync()
    t = time.perf_counter()
    reduced = devtrace.reduce(prof, FRAME_RANGE, stages.names, bounds)
    del prof
    print(f"profiled frame reduced in {time.perf_counter() - t:.1f} s", file=sys.stderr)
    return dict(wall_while_s=wall_while, **reduced)


def result_line(cell: Cell, out: dict, trace: bool, device) -> dict:
    """The result's JSON object; a reader that finds nothing leaves its
    metric out."""
    import torch

    record = out["record"]
    metrics = {}
    for spec, reader in (cell.per_layer if trace else cell.end_to_end):
        value = reader.read(record)
        if value is not None:
            metrics[spec["name"]] = dict(value=value, unit=spec["unit"])
    dev = torch.device(device)
    info = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                count=1, memory_peak_bytes=record["memory_reserved_peak_bytes"])
    line = dict(correct=out["correct"], attempted=out["attempted"], failed=out["failed"],
                metrics=metrics, device=info)
    if trace:
        prof = record["profile"]
        info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = dict(device_ops=prof["device_ops"], idle_gaps=prof["idle_gaps"])
    line["checks"] = out["checks"]
    return line


def _card(index: int = 0) -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", f"--id={index}"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = HERE.parent
    _caches(root)
    cell = Cell(args.workload, root)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 1
    with contextlib.redirect_stdout(sys.stderr):  # the program's prints stay off stdout
        try:
            out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
        except RuntimeError as e:
            if "modules loaded" not in str(e):
                raise
            print(f"{e}: no result", file=sys.stderr)
            return 1
        line = result_line(cell, out, bool(args.trace), "cuda")
    print(f"card: {_card()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)
    print(f"correct {line['correct']}: frames checked {out['checked']}; not compared (no limit "
          f"holds, PERF.md): {json.dumps(out['unchecked'])}", file=sys.stderr)
    for name, c in out["checks"].items():  # the last lines: each number beside its limit
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
