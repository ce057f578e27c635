"""K3 and K6, or the conv_mma family, of this tree against another tree's,
in turns, on one GPU.

    python -m ics_tpu_torch.ab_kernels OLD_TREE [--reps N] [--family k3k6|conv_mma]
                                       [--tree NAME=DIR ...]

``OLD_TREE`` is a checkout (or ``git archive``) of the commit to compare
with.  The trees are OLD_TREE ("old"), this one ("new") and a copy of this
package whose ``bilateral.cu`` computes each weight with the accurate
``exp2f`` in place of ``ex2.approx`` ("exp2f", written under
``_build/ab``).  Each tree's whole kernel library is built first, all three
at once.  Then every turn is a fresh process that puts one tree first on
``sys.path`` and calls that tree's own public wrappers
(``psf_gradient_planar``, ``bilateral_planar``), so the trees' C
interfaces may differ.  Turns: old, new, exp2f, exp2f, new, old.

In each turn, on inputs made from one seed: K3 at the 24 MP op loop's
369^2 mk 7 and 520^2 mk 9 windows, K6 at one 4000x6000 plane r 5 in the
ranges of the CLI's ``bilateral`` and ``bilateral-lab``.  Each result is
held against that tree's plain twin and called twice (bitwise).  Times come
from this tree's ``utils/selftest.py::_median_ms``: ``ms`` as the smoke's kernels line reads
it (the call's wrapper included) and ``device_ms`` (the GPU kept busy ahead
of the start event, so only the kernel's device time).

``--family conv_mma`` compares K4h, K4s, K4 and K4d (``csrc/conv_mma.cu``)
instead, with no exp2f tree: turns old, new, new, old.  Each turn runs the
four at the 24 MP phase-2 shape (9x9 valid on 3x4012x6012) and at 31x31
'same' on 3x2000x3000, on the same seeded inputs, each against its tree's
plain twin, called twice.  Every output is hashed: K4s's, K4's and K4d's
must be the same in both trees, and each K4h's the same in every turn of
its tree.  ``--tree NAME=DIR`` adds another checkout (a variant of this
one, say) to the turns: old, new, then each added tree twice, new, old.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
_ROOT = _PKG.parent
_APPROX = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n  return y;'
_TURNS = {"k3k6": ["old", "new", "exp2f", "exp2f", "new", "old"],
          "conv_mma": ["old", "new", "new", "old"]}
# conv_mma: (name, wrapper, operand dtype); the cases (label, shape, taps, mode)
_CONV_MMA = [("K4h", "conv_highest", "float32"), ("K4s", "conv_split", "float32"),
             ("K4", "conv_bf16", "bfloat16"), ("K4d", "conv_default", "float32")]
_CONV_MMA_CASES = [("24MP 9x9 valid", (3, 4012, 6012), 9, "valid"),
                   ("6MP 31x31 same", (3, 2000, 3000), 31, "same")]


def _smoke():
    """This tree's utils/selftest.py, for its timing helper (loaded by path:
    the worker's package may be another tree's)."""
    spec = importlib.util.spec_from_file_location("ab_selftest",
                                                  _PKG / "utils" / "selftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _exp2f_tree() -> Path:
    """A copy of this package with the accurate exp2f as K6's weight."""
    tree = _PKG / "_build" / "ab" / "exp2f"
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(_PKG, tree / _PKG.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = tree / _PKG.name / "csrc" / "bilateral.cu"
    text = src.read_text()
    if _APPROX not in text:
        raise SystemExit("bilateral.cu has no ex2.approx weight to swap")
    src.write_text(text.replace(_APPROX, "return exp2f(x);"))
    return tree


def _worker_cmd(tree: Path, *extra: str) -> list[str]:
    # -P: no script directory on sys.path, so the tree's package is the one found
    return [sys.executable, "-P", str(Path(__file__).resolve()), "--worker", str(tree), *extra]


def _import_tree(tree: Path):
    sys.path.insert(0, str(tree))
    import ics_tpu_torch

    if Path(ics_tpu_torch.__file__).resolve().parents[1] != tree.resolve():
        raise SystemExit(f"imported {ics_tpu_torch.__file__}, not the tree {tree}")
    return ics_tpu_torch


def _digest(torch, x) -> str:
    """The output's bits, hashed (bf16 read as int16)."""
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]


def _conv_mma_turn(torch, smoke, dev, reps: int) -> dict:
    """The tree's K4h, K4s, K4 and K4d at ``_CONV_MMA_CASES``."""
    from ics_tpu_torch.ops import cuda_conv_mma

    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for label, shape, mk, mode in _CONV_MMA_CASES:
        a32 = torch.rand(shape, device=dev, generator=gen) * 0.75 + 0.15
        k32 = torch.rand((shape[0], mk, mk), device=dev, generator=gen) * 0.95 + 0.05
        for name, fn, dtype in _CONV_MMA:
            a, k = a32.to(getattr(torch, dtype)), k32.to(getattr(torch, dtype))
            kern = getattr(cuda_conv_mma, fn)
            got, again = kern(a, k, mode), kern(a, k, mode)
            ref = getattr(cuda_conv_mma, f"{fn}_plain")(a, k, mode).float()
            out[f"{name} {label}"] = dict(
                rel=float((got.float() - ref).abs().max() / ref.abs().max()),
                bitwise=bool(torch.equal(got, again)), hash=_digest(torch, got),
                ms=smoke._median_ms(torch, lambda: kern(a, k, mode), reps),
                device_ms=smoke._median_ms(torch, lambda: kern(a, k, mode), reps,
                                           device_only=True),
            )
            del a, k, got, again, ref
    return out


def _worker(tree: Path, reps: int, build_only: bool, family: str = "k3k6") -> None:
    """One turn: time the tree's K3 and K6 (or its conv_mma family); the
    last line is JSON."""
    _import_tree(tree)
    from ics_tpu_torch import _build

    _build.load_library()
    if build_only:
        print(json.dumps({"build_s": _build.build_seconds}))
        return
    import torch

    from ics_tpu_torch._device import exact_f32
    from ics_tpu_torch.ops import cuda_bilateral, cuda_correlate
    from ics_tpu_torch.ops.cuda_conv import conv_planar_plain

    exact_f32()
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    if family == "conv_mma":
        print(json.dumps(_conv_mma_turn(torch, smoke, dev, reps)))
        return
    rng = np.random.default_rng(6)
    out = {}

    def run(label, fn, ref, n):
        got = fn()
        out[label] = dict(
            rel=float((got - ref).abs().max() / ref.abs().max()),
            bitwise=bool(torch.equal(got, fn())),
            ms=smoke._median_ms(torch, fn, n),
            device_ms=smoke._median_ms(torch, fn, n, device_only=True),
        )

    for m, mk in [(363, 7), (512, 9)]:
        cells = rng.uniform(0.2, 0.8, (3, m // 8 + 1, m // 8 + 1))
        img = np.kron(cells, np.ones((1, 8, 8)))[:, :m, :m]
        u = np.pad(img, ((0, 0), (mk // 2,) * 2, (mk // 2,) * 2), mode="edge")
        psf = rng.uniform(0.5, 1.0, (3, mk, mk))
        psf /= psf.sum(axis=(1, 2), keepdims=True)
        u, img, psf = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                       for a in (u, img, psf))
        err = conv_planar_plain(u, psf, "valid") - img
        run(f"K3 {m + mk - 1}^2 mk {mk}", lambda: cuda_correlate.psf_gradient_planar(u, err),
            cuda_correlate.psf_gradient_plain(u, err), reps)
    for label, scale, std_i in [("24MP plane r5 std_i 0.1", 1.0, 0.1),
                                ("24MP L plane r5 std_i 5", 100.0, 5.0)]:
        x = torch.from_numpy(rng.random((1, 4000, 6000), dtype=np.float32) * scale).to(dev)
        run(f"K6 {label}", lambda: cuda_bilateral.bilateral_planar(x, 5, std_i, 5.0),
            cuda_bilateral.bilateral_planar_plain(x, 5, std_i, 5.0), max(5, reps // 10))
        del x
    print(json.dumps(out))


def _last_json(cmd: list[str]) -> dict:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{' '.join(cmd)} failed:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_tree", nargs="?", type=Path)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--family", choices=sorted(_TURNS), default="k3k6")
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help="another tree in the turns (conv_mma)")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args.worker, args.reps, args.build_only, args.family)
        return 0
    if args.old_tree is None:
        ap.error("OLD_TREE is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    trees = {"old": args.old_tree.resolve(), "new": _ROOT}
    if args.family == "k3k6":
        trees["exp2f"] = _exp2f_tree()
    extra = dict(t.split("=", 1) for t in args.tree)
    trees.update({k: Path(v).resolve() for k, v in extra.items()})
    builds = {k: subprocess.Popen(_worker_cmd(t, "--build-only"), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
              for k, t in trees.items()}
    for k, proc in builds.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"build of {k} failed:\n{text}")
        print(f"build {k}: {text.strip().splitlines()[-1]}", flush=True)
    got: dict[str, dict[str, list[dict]]] = {}
    turns = _TURNS[args.family]
    if extra:
        turns = turns[:2] + [k for k in extra for _ in range(2)] + turns[2:]
    for k in turns:
        turn = _last_json(_worker_cmd(trees[k], "--reps", str(args.reps), "--family",
                                      args.family))
        for label, r in turn.items():
            got.setdefault(label, {}).setdefault(k, []).append(r)
    for label, by_tree in got.items():
        for k, rs in by_tree.items():
            print(f"{label} {k}: rel to twin {_series(rs, 'rel', '.3e')}; "
                  f"bitwise {all(r['bitwise'] for r in rs)}; ms {_series(rs, 'ms', '.4f')}; "
                  f"device_ms {_series(rs, 'device_ms', '.4f')}")
    ok = True
    if args.family == "conv_mma":
        ok = _hashes_hold(got)
    print(f"card: {smi}")
    return 0 if ok else 1


def _hashes_hold(got: dict) -> bool:
    """K4s, K4 and K4d give the same bits in every turn of both trees, K4h
    in every turn of each tree; prints one line per case."""
    ok = True
    for label, by_tree in got.items():
        hashes = {k: {r["hash"] for r in rs} for k, rs in by_tree.items()}
        if label.startswith("K4h "):
            hold = all(len(h) == 1 for h in hashes.values())
            what = "the same bits in every turn of each tree"
        else:
            hold = len(set().union(*hashes.values())) == 1
            what = "the same bits in both trees"
        ok &= hold
        print(f"{label}: {what}: {hold} ({json.dumps({k: sorted(h) for k, h in hashes.items()})})")
    return ok


def _series(rs: list[dict], key: str, fmt: str) -> str:
    vals = [r[key] for r in rs]
    return " ".join(format(v, fmt) for v in vals) + f" (median {format(np.median(vals), fmt)})"


if __name__ == "__main__":
    raise SystemExit(main())
