"""Headline benchmark of the port: blind RL-TV deconvolution on one GPU
(counterpart of the repository's ``bench.py``, with its flags, cases,
formulas and JSON keys).

    python -m ics_tpu_torch.bench                 # the default run, one JSON line
    python -m ics_tpu_torch.bench --selftest      # certify_kernels, exit 0 when all pass
    python -m ics_tpu_torch.bench --kernels       # the conv-backend bench
    python -m ics_tpu_torch.bench --success-rate | --precision-quality | --scaling

The default run, every case a full blind + non-blind ``deblur_module``:

1. **24 MP** (6000x4000) in exact float32, the headline (best of two timed
   runs), then in precision 'mixed' (K4, bf16 tensor-core convs) and 'high'
   (K4s, bf16x3-split tensor-core convs, DoF guard); every case runs once
   warm first, which also builds the kernels at first use.
2. The fixed-work per-outer probes at the 24 MP final level's geometry,
   exact and 'high': ``richardson_lucy_MM`` with tau 1e9, so exactly
   ``iters`` outers, and a FLOP model of its convolutions.
3. **1.9 MP** (1367x1394), the reference's published case with its own
   parameters.

The frames are the reference's ``153412.jpg`` (LANCZOS-resized to 6000x4000)
and ``blured.jpg`` from the directory ``--reference``; without it, the
smoke's synthetic scenes (``utils.selftest.make_scene``), where the
repository's ``bench.py`` takes uniform noise: the epsilon-free DoF blend is
chaotic on noise, and the shared scenes give the smoke's outer counts.

Prints ONE JSON line on stdout for the 24 MP case, the other cases nested;
everything else goes to stderr.  Runs on the GPU (``--device cuda``, the
default; it raises without one); ``--device cpu`` runs the same on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np

from ics_tpu_torch._device import resolve_device, to_f32
from ics_tpu_torch.models import rl_mm
from ics_tpu_torch.models.pipeline import deblur_module
from ics_tpu_torch.models.rl_mm import RLConfig, richardson_lucy_MM
from ics_tpu_torch.utils import selftest
from ics_tpu_torch.utils.cache import enable_persistent_cache
from ics_tpu_torch.utils.io import load_image

BASELINE_1_9MP_SECONDS = 189.0  # ref README.md:139-144
BASELINE_24MP_SECONDS = 18 * 60.0  # ref README.md:157-161 (non-blind only)

# dense bf16 tensor-core peak FLOP/s by device name (substring, lowercase):
# NVIDIA's figure for the H100 SXM at 700 W.  The f32 solve runs K1 on the
# CUDA cores, so its MFU against this peak is small by construction.
_BF16_PEAK_FLOPS = {"h100": 989e12}

# the stand-in scenes, (blur width, seed) by shape: chip_smoke.py's 24 MP
# and 1.9 MP frames
SCENES = {(4000, 6000): (9, 24), (1367, 1394): (7, 19)}

# the cases' kwargs (bench.py:336-348 and 402-413)
KW24 = dict(blur_width=9, mask=[2000, 3000], mask_size=511, display=False, tolerance=0.1,
            quality="normal", preview=False, blur="static", iterations=200, verbose=False,
            precision="exact")
KW19 = dict(blur_width=7, mask=[584, 795], display=False, tolerance=0.1, quality="normal",
            preview=False, blur="static", iterations=200, verbose=False, precision="exact")


def model_flops(m: int, n: int, mk: int) -> int:
    """The per-outer FLOP model: 5 inner iterations x 2 convs x 2*mk^2
    operations x 3 channels per pixel, the convolutions being nearly all of
    the solver's arithmetic."""
    return 5 * 2 * 2 * (mk * mk) * 3 * m * n


def _per_outer_probe(iters=10, reps=3, conv_precision="exact", device="cuda", *,
                     m=4001, n=6001, mk=9, window=(200, 700, 200, 700), reference=None):
    """Fixed-work seconds per outer at the 24 MP final level's geometry.

    ``richardson_lucy_MM`` on ``_real_image(m, n)``, its edge-padded copy as
    ``u`` and a uniform mk x mk x 3 PSF, non-blind, tau 1e9 (the stop never
    fires: exactly ``iters`` outers); one warm call, then the best of
    ``reps``, each timed call ending in a host read of ``stats.sum()``.
    ``RLConfig(conv_precision=...)`` as bench.py:379 has it, without the
    pipeline's DoF guard.  Returns (seconds per outer, ``model_flops``);
    raises when the solve's stats are not finite."""
    dev = resolve_device(device)
    pad = mk // 2
    img = selftest._real_image(m, n, reference)
    u = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    psf = np.ones((mk, mk, 3), np.float32) / (mk * mk)
    img, u, psf = (to_f32(a, dev) for a in (img, u, psf))
    top, bottom, left, right = window

    def run():
        res = richardson_lucy_MM(
            img, u, psf, top, bottom, left, right, 1e9, iterations=iters, step_factor=1e-3,
            lambd=10000.0, blind=False, verbose=False,
            config=RLConfig(conv_precision=conv_precision), device=dev,
        )
        if not np.isfinite(float(res.stats.sum())):
            raise RuntimeError(f"per-outer probe ({conv_precision}): the solve's stats are "
                               "not finite")

    run()  # warm, and the kernels' build at first use
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best / iters, model_flops(m, n, mk)


def _load(name: str, fallback_shape, reference=None) -> np.ndarray:
    """The reference's image ``name`` from ``reference``, else the stand-in
    scene of ``fallback_shape`` (``SCENES``), blurred, as uint8."""
    path = selftest._fixture(reference, name)
    if path is not None:
        return load_image(path)
    h, w = fallback_shape[:2]
    blur, seed = SCENES[(h, w)]
    return selftest.make_scene(h, w, blur, seed)[1]


def _run_case(pic, kwargs, label, reps=1, device="cuda"):
    """One warm run (the kernels' build at first use), then ``reps`` timed
    runs of ``deblur_module``, stdout sent to stderr: the best wall and the
    best ``compute_timer['compute_s']``.  Returns (elapsed_s, outers of the
    last run, compute_s); raises when a level's M_r is not finite."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        deblur_module(pic, f"{label}-warmup", None, device=device, **kwargs)
    print(f"[{label}] warmup (incl. first-use build): {time.perf_counter() - t0:.2f}s",
          file=sys.stderr)
    selftest._free_device(device)

    elapsed = compute_s = float("inf")
    for rep in range(reps):
        stats, ctimer = [], {}
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            out = deblur_module(pic, label, None, device=device, stats_out=stats,
                                compute_timer=ctimer, **kwargs)
        rep_s = time.perf_counter() - t0
        print(f"[{label}] timed run {rep + 1}/{reps}: {rep_s:.2f}s "
              f"(compute-only {ctimer.get('compute_s', float('nan')):.2f}s)", file=sys.stderr)
        elapsed = min(elapsed, rep_s)
        compute_s = min(compute_s, ctimer.get("compute_s", float("inf")))
    # the uint16 output cannot carry NaN: a diverged solve shows in M_r
    if out.dtype != np.uint16:
        raise RuntimeError(f"[{label}] output dtype {out.dtype}, expected uint16")
    if not all(np.isfinite(s["result"].M_r) for s in stats):
        raise RuntimeError(f"[{label}] solver diverged: a level's M_r is not finite")
    iters = sum(s["result"].iterations for s in stats)
    for s in stats:
        r = s["result"]
        print(f"[{label}] {s['case']} scale={s['scale']:.3f} k={s['k']}: "
              f"{r.iterations} outer, converged={r.converged}", file=sys.stderr)
    del out, stats
    rl_mm._release_capture_pool(device)  # the blocks of the case's captured bodies
    selftest._free_device(device)
    return elapsed, iters, compute_s


def _device_name(dev) -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit`` reads the limit; 'cpu' on the CPU."""
    import torch

    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", f"--id={index}"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(index)}, {line.rsplit(',', 1)[1].strip()}"


def _peak(device: str):
    return next((v for k, v in _BF16_PEAK_FLOPS.items() if k in device.lower()), None)


def _result(mp24, exact, mixed, high, probe, probe_high, mp19, case19, device) -> dict:
    """bench.py's JSON line (bench.py:416-471): each case is (elapsed_s,
    outers, compute_s), each probe (seconds per outer, model FLOPs)."""
    el24, iters24, comp24 = exact
    el24m, iters24m, comp24m = mixed
    el24h, iters24h, comp24h = high
    el19, iters19, comp19 = case19
    per_outer_s, flops = probe
    per_outer_s_high = probe_high[0]
    peak = _peak(device)
    return {
        "metric": "blind RL-TV-MM deconvolution, 24MP (6000x4000), full "
                  "pipeline, exact float32 (reference-parity math)",
        "value": round(mp24 / el24, 4),
        "unit": "MP/s/chip",
        "vs_baseline": round((mp24 / el24) / (mp24 / BASELINE_24MP_SECONDS), 2),
        "elapsed_s": round(el24, 3),
        "compute_only_s": round(comp24, 3),
        "compute_only_mp_per_s": round(mp24 / comp24, 4),
        "baseline_s": BASELINE_24MP_SECONDS,
        "iters_per_s_24mp": round(iters24 / el24, 3),
        "total_outer_iters_24mp": iters24,
        "solver_per_outer_ms_24mp_f32": round(per_outer_s * 1e3, 2),
        "solver_per_outer_ms_24mp_high": round(per_outer_s_high * 1e3, 2),
        "solver_model_gflop_per_outer": round(flops / 1e9, 2),
        "solver_model_gflop_per_s": round(flops / per_outer_s / 1e9, 1),
        "solver_mfu_pct_of_bf16_peak": (
            round(flops / per_outer_s / peak * 100, 3) if peak else None
        ),
        "case_24mp_high": {
            "metric": "same case, precision=high (bf16x3-split tensor-core convs, "
                      "K4s, else exact f32, DoF guard); the guarded stop trajectory "
                      "re-rolls the outer count",
            "value": round(mp24 / el24h, 4),
            "unit": "MP/s/chip",
            "elapsed_s": round(el24h, 3),
            "compute_only_s": round(comp24h, 3),
            "total_outer_iters": iters24h,
        },
        "case_24mp_mixed": {
            "metric": "same case, precision=mixed (bf16 tensor-core convs, K4, f32 "
                      "residual, DoF guard); the whiteness stop trajectory differs "
                      "from f32",
            "value": round(mp24 / el24m, 4),
            "unit": "MP/s/chip",
            "elapsed_s": round(el24m, 3),
            "compute_only_s": round(comp24m, 3),
            "total_outer_iters": iters24m,
        },
        "case_1_9mp": {
            "metric": "blind RL-TV-MM of img/blured.jpg (1.9MP), full "
                      "pipeline, exact f32",
            "value": round(mp19 / el19, 4),
            "unit": "MP/s/chip",
            "vs_baseline": round((mp19 / el19) / (mp19 / BASELINE_1_9MP_SECONDS), 2),
            "elapsed_s": round(el19, 3),
            "compute_only_s": round(comp19, 3),
            "baseline_s": BASELINE_1_9MP_SECONDS,
            "iters_per_s": round(iters19 / el19, 3),
        },
        "device": device,
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--selftest", action="store_true",
                    help="certify every CUDA kernel against its plain twin on the GPU "
                         "(utils.selftest.certify_kernels) and exit 0 when all pass")
    ap.add_argument("--kernels", action="store_true",
                    help="the conv-backend bench (utils.selftest.bench_conv_backends) and exit")
    ap.add_argument("--success-rate", action="store_true",
                    help="the blind-restoration success battery (the reference README's "
                         "'sharp picture within 5%% error in >50%% of tests', ref "
                         "README.md:146-148) and exit, 1 unless the rate is above 0.5")
    ap.add_argument("--precision-quality", action="store_true",
                    help="quality of each precision mode (float32/high/mixed) at the 24 MP "
                         "geometry against a synthetic truth "
                         "(utils.selftest.bench_precision_quality) and exit")
    ap.add_argument("--scaling", action="store_true",
                    help="fixed-work row-sharded solve over n=1,2,4,8 ranks "
                         "(utils.selftest.bench_scaling) and exit: one GPU per rank on "
                         "--device cuda (rank counts above the GPU count are skipped), gloo "
                         "ranks with --device cpu")
    ap.add_argument("--scaling-shape", default=None, metavar="MxN",
                    help="frame shape for --scaling (default 511x767; 4001x6001 is the "
                         "24 MP final level's)")
    ap.add_argument("--scaling-iters", type=int, default=None, metavar="K",
                    help="fixed outer-iteration count per --scaling run (default 6)")
    ap.add_argument("--scaling-reps", type=int, default=None, metavar="R",
                    help="timed repetitions per rank count for --scaling (default 3)")
    ap.add_argument("--reference", default=None, metavar="DIR",
                    help="directory of the reference's images (153412.jpg, blured.jpg, "
                         "original.jpg, crop-blured.jpg), read-only; default: the "
                         "synthetic stand-ins")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    return ap


def _stderr(*a) -> None:
    print(*a, file=sys.stderr)


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    enable_persistent_cache()

    if args.scaling:
        scaling_kw = {}
        if args.scaling_shape:
            m_s, n_s = args.scaling_shape.lower().split("x")
            scaling_kw.update(m=int(m_s), n=int(n_s))
        if args.scaling_iters is not None:
            scaling_kw["iterations"] = args.scaling_iters
        if args.scaling_reps is not None:
            scaling_kw["reps"] = args.scaling_reps
        selftest.bench_scaling(**scaling_kw, device=args.device)
        raise SystemExit(0)

    dev = resolve_device(args.device)

    if args.precision_quality:
        results = selftest.bench_precision_quality(report=_stderr, device=dev,
                                                   reference=args.reference)
        print(json.dumps({
            "metric": "precision-mode quality, 24MP synthetic pair "
                      "(blob-9 linear-light blur of the bench frame), "
                      "full blind pipeline, SSIM/PSNR vs truth",
            "value": results.get("high", {}).get("ssim"),
            "unit": "SSIM (precision=high)",
            "vs_baseline": (
                round(results["high"]["ssim"] / results["float32"]["ssim"], 4)
                if "high" in results and "float32" in results else None
            ),
            "modes": results,
        }))
        raise SystemExit(0)

    if args.success_rate:
        rate, rows = selftest.bench_success_rate(device=dev, reference=args.reference)
        print(json.dumps({
            "metric": "blind-restoration success rate (restored rel-L2 "
                      "error < 5% vs sharp original AND SSIM improved, "
                      "12-case synthetic battery incl. motion blurs)",
            "value": rate,
            "unit": "fraction",
            "vs_baseline": round(rate / 0.5, 2),  # ref claim: >50%
            "cases": {
                name: {"input_err": round(ie, 4),
                       "restored_err": round(oe, 4),
                       "input_ssim": round(is_, 4),
                       "restored_ssim": round(os_, 4),
                       "success": s}
                for name, ie, oe, is_, os_, s in rows
            },
        }))
        raise SystemExit(0 if rate > 0.5 else 1)

    if args.selftest or args.kernels:
        ok = True
        if args.selftest:
            ok = selftest.certify_kernels(device=dev)
        if args.kernels:
            selftest.bench_conv_backends(device=dev)
        raise SystemExit(0 if ok else 1)

    device = _device_name(dev)

    # ---- 24 MP: exact f32 (the headline), then mixed and high
    pic24 = _load("153412.jpg", (4000, 6000, 3), args.reference)
    if pic24.shape[:2] != (4000, 6000):  # the reference's frame, as bench.py:330-333
        from PIL import Image

        pic24 = np.asarray(Image.fromarray(np.asarray(pic24, np.uint8)).resize(
            (6000, 4000), Image.LANCZOS))
    mp24 = pic24.shape[0] * pic24.shape[1] / 1e6
    exact = _run_case(pic24, KW24, "bench-24mp", reps=2, device=dev)
    mixed = _run_case(pic24, {**KW24, "precision": "mixed"}, "bench-24mp-mixed", device=dev)
    high = _run_case(pic24, {**KW24, "precision": "high"}, "bench-24mp-high", device=dev)

    # ---- the fixed-work per-outer probes at the final level's geometry
    probe = _per_outer_probe(device=dev, reference=args.reference)
    probe_high = _per_outer_probe(conv_precision="high", device=dev, reference=args.reference)
    (per_outer_s, flops), per_outer_s_high = probe, probe_high[0]
    peak = _peak(device)
    _stderr(f"[probe] 24MP f32 per-outer: {per_outer_s * 1e3:.1f} ms, "
            f"model {flops / per_outer_s / 1e9:.0f} GFLOP/s"
            + (f", MFU {flops / per_outer_s / peak * 100:.2f}% of bf16 tensor-core peak"
               if peak else ""))
    _stderr(f"[probe] 24MP 'high' per-outer: {per_outer_s_high * 1e3:.1f} ms "
            f"({per_outer_s / per_outer_s_high:.2f}x f32)"
            + (f", MFU {flops / per_outer_s_high / peak * 100:.2f}% of bf16 tensor-core peak"
               if peak else ""))

    # ---- 1.9 MP, exact f32 (the reference's own case)
    pic19 = _load("blured.jpg", (1367, 1394, 3), args.reference)
    mp19 = pic19.shape[0] * pic19.shape[1] / 1e6
    case19 = _run_case(pic19, KW19, "bench-1.9mp", device=dev)

    print(json.dumps(_result(mp24, exact, mixed, high, probe, probe_high, mp19, case19,
                             device)))


if __name__ == "__main__":
    main()
