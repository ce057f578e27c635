#!/usr/bin/env python3
"""Smoke run of the ``ics_tpu_torch`` port on one NVIDIA GPU.

    python3 chip_smoke.py     # one GPU, a few minutes with the kernel build
    python3 chip_smoke.py --deblur-batch-against DIR
        # the CLI deblur-batch's wall from the checkout DIR against this one
    python3 chip_smoke.py --capture-memory
        # three runs of each 1.9 MP and 24 MP case: capture and
        # instantiation ms per solve, peak and reserved memory, and the
        # memory that releasing the capture pool hands back
    python3 chip_smoke.py --profiled-while on|off
        # three reps of 24 MP exact, 'pd' and the 4x24 MP 'map' burst in the
        # WHILE loop, under torch.profiler or not (fault E, ROADMAP.md)
    python3 chip_smoke.py --outer-loop-profiles
        # phase 5's profiled 24 MP exact, 'high', 'mixed', 'pam' and 'pd'
        # runs in the WHILE outer loop and in the host loop, in turns

Phases:
  1. probe: the card and its driver (nvidia-smi), torch.version.cuda, nvcc,
     kernel build; the CUDA driver's and the kernel library's runtime
     versions, ``CUDAGraph(keep_graph=True)`` and ``raw_cuda_graph()``, and
     a WHILE node whose body holds the cooperative kernels K2 and K3, held
     bitwise against the same outers run eagerly;
  2. ``ics_tpu_torch.utils.selftest.certify_kernels``: each
     hand-written kernel (K1 conv, K2 inner loop, K3 PSF gradient, K4s
     split, K4 bf16, K4h f32-at-HIGHEST and K4d f32-at-DEFAULT tensor-core
     convs, K5 TV stencil, K6 bilateral filter, K7 the outer loop's stop;
     K7w, which hands K7's ``go`` to the WHILE node, by its effect: the node
     runs outers - 1 bodies and leaves K7's twin's state; the banded resize)
     against its plain PyTorch twin on the card, at its path's
     shapes, with CUDA-event median times of both and of the one PyTorch
     call that computes the same function where there is one, taken in
     turns (the kernel's also as device time alone, ``device_ms``); every
     kernel runs twice, the card synchronized after each call so that a
     fault names its kernel and call, and must be bitwise equal; K2 also
     runs at the op loop's 24 MP windows beside the op loop
     (informational); then the K2 inner loop against the op loop on a
     255^2 blind solve, and the pipeline's pre- and postprocess and cubic
     resize against one op at a time.  Each kernel's bound (the least time
     the card could take: bytes over 3.35 TB/s or operations over the peak
     rate of their type, whichever is larger) is computed from the shapes
     (K6's also counts the exponentials the function needs at the SFU's
     rate).  Every one-image solve from phase 3 on (MM, PAM, PD) and
     ``tv_denoise`` runs its outers after the first as one launch of a
     WHILE graph, the stop decided on the card by K7 (models/rl_mm.py);
     phases 11 and 12 hold that loop against the host loop, the same
     body launched outer by outer;
  3. the crop-scale pipeline on CUDA against the same pipeline on the CPU
     (SSIM of the uint16 outputs), in exact, mixed, high, fast, use_tv
     under each tv_norm, and with the TV-PAM and TV-PD solvers;
  4. the 1.9 MP reference case (bench.py's kwargs) on a synthetic scene,
     then again with ``inner_loop='xla'`` (the op loop with K3 where
     'auto' runs K2: K3 > 0, K2 == 0, SSIM >= 0.999 against 'auto'), then
     with ``solver='pam'`` (K1, K3, K5 > 0) and ``solver='pd'`` (K3 > 0),
     each with its launches and, informational, every solver's SSIM
     against the sharp scene;
  5. the 24 MP case (bench.py's kwargs) in exact f32, the main path, then
     in precision 'high', in 'mixed', with use_tv, and with the 'pam' and
     'pd' solvers: the launch counters are zeroed just before each run;
     K1-K3, K7, K7w, K8 and the resize must be > 0 after the exact run, K4s after 'high',
     K4 after 'mixed', K5 after use_tv, K1, K3 and K5 after 'pam' and K3
     after 'pd'; then SSIM of the 24 MP scene as CUDA tensors (the
     metrics' device path in bands, K1) against its float64 host path;
     then exact, 'high', 'mixed', 'pam' and 'pd' twice more each: in the
     WHILE loop, unprofiled, the wall, the solves, their host reads,
     capture and instantiation time; in the host loop under
     torch.profiler each kernel's summed device time and launches, K1, K4s
     and K4 split into full frames and blind windows (one profiled kernel
     per wrapper launch), one psf_grad kernel per K3 call, the device time
     per outer, cuFFT's share, its busy share, and that device time over
     the WHILE loop's wall (derived from two runs: no WHILE launch runs
     under the profiler, ``profile_run``); then the time of one
     rfft2 + irfft2 pair on PD's prime-length frame against a smooth one;
  6. the command line (``ics_tpu_torch.cli.main``) on the card, TIFF in and
     TIFF out: ``bilateral``, ``bilateral-lab``, ``usm`` and ``tv-denoise``
     with their defaults on the 24 MP frame (K6 > 0 after each bilateral
     run, K1 > 0 after usm, counters zeroed before each), ``deblur`` on the
     1.9 MP frame with each solver (K1, K2 > 0 for 'mm'; each TIFF bitwise
     equal to phase 4's array of its solver), and ``bilateral`` /
     ``bilateral-lab`` at crop scale on CUDA against the CPU, within one
     16-bit code;
  7. batching and many ranks (``ics_tpu_torch.parallel``): (a) a burst of
     four 24 MP frames, non-blind with one 9x9 PSF, through
     ``batched_deconvolve`` 'map' (each lane bitwise one
     ``richardson_lucy_MM`` call) and 'vmap' (SSIM >= 0.999 against 'map';
     K1 at most 10 launches per outer of the slowest lane), each profiled
     ('map''s lanes in the host loop, 'vmap' in the fold's loop) for its
     device time per outer per lane and peak memory ('map''s lanes against
     WHILE-loop calls); (b) the CLI
     ``deblur-batch`` on those frames as 16-bit TIFFs, alone and with
     ``--shard 1`` (one NCCL rank), bitwise equal to each other and to
     (a)'s 'map' run; (c) the 24 MP ``deblur_module(mesh=...)`` on two
     gloo ranks sharing cuda:0 (their arrays and blind PSFs bitwise equal,
     SSIM >= 0.999 against phase 5); (d) ``sharded_richardson_lucy`` at the
     24 MP final level's shape, 10 outers, against one device (u 5e-5,
     stats 1e-6) and bitwise reproducible, then with a mask window in the
     second rank's rows only; (e) ``deblur --shard 1`` at 1.9
     MP, SSIM >= 0.999 against phase 4;
  8. the host tier, the batteries and the examples: (a) the native runtime
     (``ics_tpu_torch.runtime``) built at first use; its LZW and PackBits
     coders on the 24 MP scene as 16-bit RGB, bytes equal to the
     pure-Python coders' (which run in four worker processes meanwhile)
     and decoding back, both timed; ``imread_sequence`` of phase 7's four
     TIFFs with and without the prefetcher, on cached files and on files
     dropped from the page cache (equal arrays, both walls); the
     CLI ``bilateral`` at 24 MP with the TIFF read, the filter and the
     TIFF write timed apart; (b) ``utils.selftest``'s success battery (12
     finite rows), the 24 MP precision-quality battery (finite scores,
     outers per mode), the conv bench and the scaling bench on one NCCL
     rank, the counters zeroed before each; (c) the four examples
     (``ics_tpu_torch.examples``) on a 512^2 scene TIFF, each output a
     uint16 TIFF of the expected shape;
  9. the explicit conv methods (``RLConfig.conv_method``): the 24 MP scene,
     non-blind, full width, 20 outers (tau 1e9) with 'auto' (K1), then
     'pallas_mxu' at exact (K4h launched, K1 not, u within 1e-5 of 'auto')
     and at 'fast' (K4d, SSIM >= 0.999 against 'auto'); a blind solve of
     the 1.9 MP case's 255^2 mask window with 'pallas_mxu' and
     ``inner_loop='xla'`` (K4h and K3 launched; u within 1e-6 and PSF
     within 1e-5 of the 'auto' op loop); 'direct', 'fft', 'stencil',
     'pallas' and 'mxu' at 1.9 MP, non-blind, 20 outers, each within 1e-5
     of 'auto' with the launches that show its route; then K4h and K4d
     against their twins at every shape these runs gave them;
 10. the bench (``ics_tpu_torch.bench``): its ``_run_case`` on phase 4's
     1.9 MP scene with phase 4's outer count, its per-outer probes at the
     24 MP final level's geometry (2 outers, exact and 'high', K1 and K4s
     launched, finite), the exact probe's device time per outer by kernel
     (torch.profiler), and its JSON line assembled from these and phase
     5's 24 MP runs (``bench.KW24``), with BENCH_r05.json's keys;
 11. the outer loop: each solve case in the WHILE loop (untimed), in the
     host loop, the captured body launched outer by outer
     (``rl_mm._eager_outer_loop()``), and in the WHILE loop again, bitwise
     equal (u, u_full, psf, image, stats, the record; ``deblur_module``'s
     uint16 output and every level's result), the same outers and launches
     (K7 once per outer in both, K7w in the WHILE loop only), one host read
     per solve against one per outer; the
     1.9 MP blind mask window (K2), a 24 MP blind 520^2 window (the op loop,
     K3), the 24 MP non-blind frame at 20 outers, the 1.9 MP frame in
     'high', 'mixed' and use_tv collab, non-blind early_stop,
     record_metrics, and ``deblur_module`` at 1.9 MP (the host loop also
     profiled: its busy share, and its device time over the WHILE loop's
     wall) and 24 MP exact (peak memory of
     both); walls, host reads,
     capture and instantiation milliseconds per solve.  At most 60 s;
 12. PAM, PD and ``tv_denoise`` on the same loop, as in phase 11: PAM and
     PD on the 1.9 MP blind mask window and non-blind frame (20 outers),
     ``deblur_module`` at 1.9 MP with each, the 24 MP PD frame at 20 fixed
     outers, and ``tv_denoise`` (50 iterations) on the 24 MP frame, which
     reads nothing until its result.  At most 90 s.

SSIM comes from ``ics_tpu_torch.utils.metrics``; every pass/fail comparison
computes it on the CPU, so the yardstick is independent of the kernels.
Any failure exits non-zero before the last line, which is one JSON object
``{"ok": true, "device": {...}}``; the line before it holds the kernels'
numbers as JSON.  Imports neither JAX nor ``ics_tpu``; needs a CUDA GPU.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

# the bench's cases, the scenes, the CUDA-event timer and phase 2's kernel
# certification
from ics_tpu_torch import bench
from ics_tpu_torch.utils import selftest
from ics_tpu_torch.utils.selftest import make_scene


class SmokeFailure(Exception):
    pass


def _require(cond: bool, what: str) -> None:
    print(("PASS " if cond else "FAIL ") + what, flush=True)
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- phase 1
def probe_while_node(torch, dev) -> None:
    """What the WHILE route needs: the CUDA driver's and the kernel library's
    runtime versions (12.3 or later), ``CUDAGraph(keep_graph=True)`` and
    ``raw_cuda_graph()``, then a WHILE node whose body holds the cooperative
    kernels K2 and K3 (CUDA allows them in a conditional body only without
    MPS): five outers of a 61^2 blind K2 step and a K3 gradient, counted by
    K7, built, launched and held bitwise against the same five outers run
    eagerly."""
    from ics_tpu_torch.models import rl_mm
    from ics_tpu_torch.ops import cuda_correlate, cuda_outer, cuda_solver

    driver, runtime = cuda_outer.cuda_versions()
    print(f"CUDA driver {driver}, kernel library runtime {runtime} (cudaDriverGetVersion, "
          f"cudaRuntimeGetVersion; WHILE nodes need 12030)")
    try:
        keep = torch.cuda.CUDAGraph(keep_graph=True)
        del keep
        keep_graph = True
    except TypeError:
        keep_graph = False
    raw = hasattr(torch.cuda.CUDAGraph, "raw_cuda_graph")
    print(f"torch.cuda.CUDAGraph(keep_graph=True): {keep_graph}, raw_cuda_graph(): {raw}")
    _require(driver >= 12030 and runtime >= 12030 and keep_graph and raw,
             "the WHILE route's CUDA 12.3 and torch keep_graph/raw_cuda_graph are there")
    gen = torch.Generator(device=dev).manual_seed(5)
    image = torch.rand((3, 61, 61), device=dev, generator=gen) * 0.6 + 0.2
    u0 = torch.nn.functional.pad(image[None], (2, 2, 2, 2), mode="replicate")[0].contiguous()
    psf0 = torch.full((3, 5, 5), 1.0 / 25, device=dev)

    def outer(u, psf, gk):
        u, psf, err = cuda_solver.inner_loop_planar(u, image, psf, step_factor=1e-3,
                                                    lambd=1e3, blind=True, correlation=False)
        return dict(u=u, psf=psf, gk=cuda_correlate.psf_gradient_planar(u, err))

    state = dict(u=u0.clone(), psf=psf0.clone(), gk=torch.zeros_like(psf0))
    for _ in range(5):
        state = outer(**state)
    st = rl_mm._Outer(5, u=u0.clone(), psf=psf0.clone(), gk=torch.zeros_like(psf0))
    t0 = time.perf_counter()
    rl_mm._state_loop(outer, st, iterations=5, blind=True, tau=0.0, use_stopping=False)
    wall = time.perf_counter() - t0
    log = rl_mm.loop_log[-1]
    same = all(torch.equal(getattr(st, k), state[k]) for k in state)
    print(f"WHILE node over a body with K2 and K3 (cooperative launches): route "
          f"{log['route']}, {log['outers']} outers, {log['reads']} read, capture "
          f"{log['capture_ms']:.2f} ms, build + instantiation {log['instantiate_ms']:.2f} ms, "
          f"{wall * 1e3:.2f} ms in all; bitwise equal to the eager outers: {same}")
    _require(log["route"] == "while" and log["outers"] == 5 and log["reads"] == 1 and same,
             "a WHILE node runs cooperative K2 and K3 in its body, bitwise the eager outers")


# ---------------------------------------------------------------- phase 2
def phase_kernels(dev) -> dict:
    """``certify_kernels``: K1-K6 against their twins at the 24
    MP path's shapes (each call twice, the card synchronized after each),
    the K2 inner loop against the op loop, the glue against one op at a
    time.  The first failure, or the kernel and call that raised, fails the
    smoke."""
    rows, failures = {}, []

    def report(line: str) -> None:
        print(line, flush=True)
        if line.startswith(("[selftest] FAIL", "[selftest] ERROR")):
            failures.append(line)

    ok = selftest.certify_kernels(report=report, device=dev, rows=rows)
    _require(ok and not failures,
             "certify_kernels: " + (failures[0] if failures else "every check passed"))
    return rows


# ------------------------------------------------------------ phases 3-5
def _deblur(torch, pic, device, **kw):
    from ics_tpu_torch import deblur_module

    stats, timer = [], {}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = deblur_module(pic, "smoke", None, stats_out=stats,
                            compute_timer=timer, device=device, **kw)
    wall = time.perf_counter() - t0
    _require("result contains NaN" not in buf.getvalue(),
             f"{device} pipeline output has no NaN")
    _require(out.dtype == np.uint16 and out.shape == pic.shape,
             f"{device} output is uint16 of shape {pic.shape}")
    levels = [
        (s["case"], round(float(s["scale"]), 3), s["result"].iterations,
         s["result"].converged)
        for s in stats
    ]
    return out, wall, timer["compute_s"], levels


def _report(label, wall, compute, levels):
    outers = sum(n for _, _, n, _ in levels)
    print(f"{label}: wall {wall:.3f} s, compute-only {compute:.3f} s, {outers} outers")
    for case, scale, n, conv in levels:
        print(f"  {case:9s} scale {scale:.3f}: {n} outers, converged={conv}")


def _counters():
    """{kernel: launches so far} over every wrapper's counter, once the
    fixed-count WHILE launches not read yet are counted (K7w's own count on
    the card, models/rl_mm.py::_settle_unread)."""
    from ics_tpu_torch.models import rl_mm
    from ics_tpu_torch.ops import (cuda_bilateral, cuda_conv, cuda_conv_mma, cuda_correlate,
                                   cuda_outer, cuda_resize, cuda_solver, cuda_step, cuda_tv)

    rl_mm._settle_unread()
    return {
        "K1": cuda_conv.launches, "K2": cuda_solver.launches,
        "K3": cuda_correlate.launches, "K4s": cuda_conv_mma.split_launches,
        "K4": cuda_conv_mma.bf16_launches, "K4h": cuda_conv_mma.highest_launches,
        "K4d": cuda_conv_mma.default_launches, "K5": cuda_tv.launches,
        "K6": cuda_bilateral.launches, "K7": cuda_outer.launches,
        "K7w": cuda_outer.while_launches, "resize": cuda_resize.launches,
        "K8": cuda_step.launches,
    }


def _zero_counters() -> None:
    from ics_tpu_torch.models import rl_mm
    from ics_tpu_torch.ops import (cuda_bilateral, cuda_conv, cuda_conv_mma, cuda_correlate,
                                   cuda_outer, cuda_resize, cuda_solver, cuda_step, cuda_tv)

    rl_mm._settle_unread()  # an earlier run's launches are not counted after the zero
    for mod in (cuda_conv, cuda_solver, cuda_correlate, cuda_tv, cuda_bilateral, cuda_outer,
                cuda_resize, cuda_step):
        mod.launches = 0
    cuda_outer.while_launches = 0
    cuda_conv_mma.split_launches = cuda_conv_mma.bf16_launches = 0
    cuda_conv_mma.highest_launches = cuda_conv_mma.default_launches = 0


# the kernels each solver family's path must launch
SOLVER_KERNELS = {"pam": ("K1", "K3", "K5"), "pd": ("K3",)}


def phase_pipelines(torch, dev):
    from ics_tpu_torch.utils import metrics

    def ssim(a, b):
        """On the CPU: a K1 fault cannot pass a comparison."""
        return metrics.ssim(a, b, device="cpu")

    # 3. crop scale, CUDA vs CPU, in every mode and solver this port runs
    crops = {5: make_scene(257, 263, 5, seed=3)[1], 9: make_scene(257, 263, 9, seed=9)[1]}
    for label, blur, extra, bound in [
        ("exact", 5, {}, 0.999),
        ("mixed", 5, dict(precision="mixed"), 0.999),
        ("high", 9, dict(precision="high"), 0.999),
        ("fast", 5, dict(precision="fast"), 0.999),
        ("use_tv collab", 5, dict(use_tv=True, tv_norm="collab"), 0.999),
        ("use_tv channel", 5, dict(use_tv=True, tv_norm="channel"), 0.999),
        ("use_tv collab_l2", 5, dict(use_tv=True, tv_norm="collab_l2"), 0.999),
        ("solver=pam", 5, dict(solver="pam"), 0.999),
        ("solver=pd", 5, dict(solver="pd"), 0.999),
    ]:
        kw = dict(blur_width=blur, mask_size=101, iterations=30, tolerance=0.1,
                  verbose=False, **extra)
        out_gpu, wall, comp, levels = _deblur(torch, crops[blur], "cuda", **kw)
        out_cpu, wall_c, comp_c, levels_c = _deblur(torch, crops[blur], "cpu", **kw)
        _report(f"crop 257x263 blur {blur} {label} cuda", wall, comp, levels)
        _report(f"crop 257x263 blur {blur} {label} cpu", wall_c, comp_c, levels_c)
        s = ssim(out_gpu / 65535.0, out_cpu / 65535.0)
        print(f"crop {label} SSIM cuda vs cpu: {s:.6f}")
        _require(s >= bound, f"{label}: port on CUDA vs port on CPU SSIM >= {bound}")

    # 4. the 1.9 MP reference case (bench.py:402-413)
    sharp19, pic19 = make_scene(1367, 1394, *bench.SCENES[(1367, 1394)])
    kw19 = bench.KW19
    out19, wall, comp, levels = _deblur(torch, pic19, "cuda", **kw19)
    _report("1.9MP 1367x1394", wall, comp, levels)
    # (wall, outers, compute-only) of the bench's cases, for phase 10
    cases = {"1.9mp": (wall, sum(n for _, _, n, _ in levels), comp)}
    # the same case with inner_loop='xla': the op loop, with K3, on the
    # blind windows that take K2 under 'auto'
    _zero_counters()
    out_xla, wall, comp, levels = _deblur(torch, pic19, "cuda", inner_loop="xla", **kw19)
    counts = _counters()
    _report("1.9MP 1367x1394 inner_loop='xla'", wall, comp, levels)
    s = ssim(out_xla / 65535.0, out19 / 65535.0)
    print(f"1.9MP inner_loop='xla' launches: {json.dumps(counts)}; SSIM against 'auto' {s:.6f}")
    _require(counts["K3"] > 0 and counts["K2"] == 0,
             "inner_loop='xla' runs the op loop: K3 launched, K2 not")
    _require(s >= 0.999, "inner_loop='xla' SSIM >= 0.999 against 'auto'")
    # the same case with the other solver families
    outs19 = {"mm": out19}
    for solver, names in SOLVER_KERNELS.items():
        _zero_counters()
        outs19[solver], wall, comp, levels = _deblur(torch, pic19, "cuda", solver=solver, **kw19)
        counts = _counters()
        _report(f"1.9MP 1367x1394 solver={solver}", wall, comp, levels)
        print(f"1.9MP solver={solver} launches: {json.dumps(counts)}")
        _require(all(counts[n] > 0 for n in names),
                 f"{', '.join(names)} launched on the 1.9 MP solver={solver} path")
    print(f"1.9MP SSIM vs sharp (informational): blurred {ssim(pic19 / 255.0, sharp19):.4f}, "
          + ", ".join(f"{k} {ssim(v / 65535.0, sharp19):.4f}" for k, v in outs19.items()))

    # 5. the 24 MP case (bench.py:336-348): the main path in exact f32, then
    # the paths of K4s, K4 and K5 and the other solver families; the
    # counters are zeroed just before each run and read just after it
    sharp24, pic24 = make_scene(4000, 6000, *bench.SCENES[(4000, 6000)])
    kw24 = bench.KW24
    launches, solver_launches = {}, {}
    for label, extra, names in [
        ("exact", dict(precision="exact"), ("K1", "K2", "K3", "K7", "K7w", "resize", "K8")),
        ("high", dict(precision="high"), ("K4s",)),
        ("mixed", dict(precision="mixed"), ("K4",)),
        ("use_tv collab", dict(precision="exact", use_tv=True, tv_norm="collab"), ("K5",)),
        *((f"solver={solver}", dict(solver=solver), names)
          for solver, names in SOLVER_KERNELS.items()),
    ]:
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counters()
        out24, wall, comp, levels = _deblur(torch, pic24, "cuda", **{**kw24, **extra})
        counts = _counters()
        if label == "exact":
            out24_exact, levels24_exact = out24, levels
        if label in ("exact", "high", "mixed"):
            cases[label] = (wall, sum(n for _, _, n, _ in levels), comp)
        _report(f"24MP 4000x6000 {label}", wall, comp, levels)
        print(f"24MP {label} peak device memory: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
        print(f"24MP {label} launches: {json.dumps(counts)}")
        _require(all(counts[n] > 0 for n in names),
                 f"{', '.join(names)} launched on the 24 MP {label} path")
        if "solver" in extra:
            solver_launches[extra["solver"]] = counts
        else:
            launches.update({n: counts[n] for n in names})
    print(f"24MP solver launches: {json.dumps(solver_launches)}")
    # the metrics' device path on the card, in bands, against the float64
    # host path: float32 window means cancel in E[x^2] - E[x]^2 on this
    # smooth scene, which moves the mean SSIM by about 1e-5 in any float32
    # summation order
    blurred24 = (pic24 / 255.0).astype(np.float32)
    _zero_counters()
    on_card = metrics.ssim(torch.from_numpy(sharp24).to(dev), torch.from_numpy(blurred24).to(dev))
    k1 = _counters()["K1"]
    on_host = ssim(sharp24, blurred24)
    print(f"24MP SSIM sharp vs blurred: CUDA tensors {on_card:.9f} ({k1} K1 launches), "
          f"host path {on_host:.9f}, difference {on_card - on_host:.3e}")
    _require(k1 > 0 and abs(on_card - on_host) <= 2e-5,
             "24 MP SSIM of CUDA tensors stays on the card (K1) within 2e-5 of the host path")
    for extra in (dict(precision="exact"), dict(precision="high"), dict(precision="mixed"),
                  dict(solver="pam"), dict(solver="pd")):
        profile_run(torch, pic24, kw24, extra)
    prime_fft_times(torch, dev)
    return launches, pic19, outs19, pic24, (out24_exact, levels24_exact), cases


def prime_fft_times(torch, dev) -> None:
    """Event time of one rfft2 + irfft2 pair on PD's 24 MP final-level frame
    (3x4003x6003; 4003 is prime) against the smooth 3x4000x6000."""
    g = torch.Generator(device=dev).manual_seed(7)
    for shape in ((3, 4003, 6003), (3, 4000, 6000)):
        x = torch.rand(shape, generator=g, device=dev)
        fft_ms = selftest._median_ms(
            torch, lambda: torch.fft.irfft2(torch.fft.rfft2(x), s=shape[1:]), 5)
        print(f"cuFFT rfft2 + irfft2 f32 {'x'.join(map(str, shape))}: {fft_ms:.3f} ms")
        del x


# conv_mma_kernel<V, K>: V is csrc/conv_mma.cu's variant (0 K4, 1 K4s, 2 K4h, 3 K4d)
_KERNEL_NAMES = [("conv2d_kernel", "K1"), ("inner_loop_kernel", "K2"), ("psf_grad", "K3"),
                 ("conv_mma_kernel<1,", "K4s"), ("conv_mma_kernel<0,", "K4"),
                 ("conv_mma_kernel<2,", "K4h"), ("conv_mma_kernel<3,", "K4d"),
                 ("tv_kernel", "K5"), ("bilateral_kernel", "K6"), ("outer_stop_kernel", "K7"),
                 ("while_go_kernel", "K7w"), ("mm_step_", "K8")]


# the wrappers whose launches are split by shape class in the profile
_BY_SHAPE = {"K1": ("cuda_conv", "conv_planar"), "K4s": ("cuda_conv_mma", "conv_split"),
             "K4": ("cuda_conv_mma", "conv_bf16")}


_captured = []  # (add, key) of the wrapper calls in the graph being captured


def _note(add, key) -> None:
    """``add(key, 1)`` for a wrapper call that launches; a call made while a
    CUDA graph is captured launches once per body that the WHILE node runs
    (``_replays_noted``)."""
    import torch

    if torch.cuda.is_current_stream_capturing():
        _captured.append((add, key))
    else:
        add(key, 1)


@contextlib.contextmanager
def _replays_noted():
    """Within the block, each WHILE launch of a solve (models/rl_mm.py::
    _while_loop) adds the wrapper calls noted during its body's capture,
    times the bodies the node ran, as the launch counters do."""
    from ics_tpu_torch.models import rl_mm

    loop, count = rl_mm._while_loop, rl_mm._count_replays

    def while_loop(*args, **kw):
        _captured.clear()
        return loop(*args, **kw)

    def count_replays(per_body, outers):
        for add, key in _captured:
            add(key, outers)
        count(per_body, outers)

    rl_mm._while_loop, rl_mm._count_replays = while_loop, count_replays
    try:
        yield
    finally:
        rl_mm._while_loop, rl_mm._count_replays = loop, count


def profile_run(torch, pic24, kw24, extra: dict) -> None:
    """One more 24 MP run with ``extra`` (a precision or a solver) in the
    WHILE loop, unprofiled: its wall, solves, host reads, capture and
    instantiation time.  Then one under torch.profiler, which puts every
    solve in the host loop (``rl_mm._eager_loop``): its wall, device
    busy seconds and busy share, each kernel's summed device time and
    launches, K1, K4s and K4 split by shape class (a full frame, or a blind
    window of at most 600x600: the op loop's 369^2 and 520^2 levels), and
    cuFFT's share.  Both loops run the same kernels on the same shapes;
    that device time over the WHILE loop's wall is printed as a derived
    number, not as the WHILE run's busy share, which no trace here reads.
    No WHILE launch runs under the profiler: on this stack it names kernels
    inside the node's bodies wrongly, drops their events as a process goes
    on, and a profiled WHILE run once hit an illegal memory access
    (ROADMAP.md section 3, fault E)."""
    label = " ".join(f"{v}" if k == "precision" else f"{k}={v}" for k, v in extra.items())
    from torch.profiler import ProfilerActivity, profile

    from ics_tpu_torch.models import rl_mm
    from ics_tpu_torch.ops import cuda_conv, cuda_conv_mma

    _zero_counters()
    rl_mm.loop_log.clear()
    t0 = time.perf_counter()
    _, _, _, levels = _deblur(torch, pic24, "cuda", **{**kw24, **extra})
    wall_while = time.perf_counter() - t0
    counts, solves = _counters(), list(rl_mm.loop_log)
    outers = sum(n for _, _, n, _ in levels)
    _require(sum(e["outers"] for e in solves) == outers == counts["K7"] == counts["K7w"]
             and all(e["route"] == "while" and e["reads"] == (e["outers"] > 1)
                     and e["k7w"] == (e["outers"] if e["outers"] > 1 else 0) for e in solves),
             f"24MP {label}: every level one WHILE solve and one read, K7 and K7w (its count on "
             "the card) once per outer")
    print(f"24MP {label} WHILE loop: wall {wall_while:.3f} s, {len(solves)} solves, host reads "
          f"{sum(e['reads'] for e in solves)}, capture ms "
          f"{sum(e['capture_ms'] or 0.0 for e in solves):.1f}, build + instantiation ms "
          f"{sum(e['instantiate_ms'] or 0.0 for e in solves):.1f}")
    mods = {"cuda_conv": cuda_conv, "cuda_conv_mma": cuda_conv_mma}
    classes = {kid: [] for kid in _BY_SHAPE}  # per kernel, one entry per launch
    originals = {kid: getattr(mods[m], f) for kid, (m, f) in _BY_SHAPE.items()}

    def classified(kid):
        def call(a, k, mode):
            if a.device.type == "cuda":
                size = a.shape[1] * a.shape[2]
                classes[kid].append("window" if size <= 600 * 600 else "frame")
            return originals[kid](a, k, mode)
        return call

    for kid, (m, f) in _BY_SHAPE.items():
        setattr(mods[m], f, classified(kid))
    try:
        _zero_counters()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the host loop
            t0 = time.perf_counter()
            _, _, _, levels = _deblur(torch, pic24, "cuda", **{**kw24, **extra})
            wall = time.perf_counter() - t0
        counts = _counters()
    finally:
        for kid, (m, f) in _BY_SHAPE.items():
            setattr(mods[m], f, originals[kid])
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    _require(sum(n for _, _, n, _ in levels) == outers, f"24MP {label}: the same outers in both "
             "loops")
    print(f"profile 24MP {label} eager loop: wall {wall:.3f} s (profiled), device busy "
          f"{busy:.3f} s, busy share {busy / wall:.3f}, {len(kernels)} device events, {outers} "
          f"outers, {busy / outers * 1e3:.3f} ms device time per outer (all levels); derived: "
          f"that device time over the WHILE loop's wall {busy / wall_while:.3f} (not a trace of "
          "the WHILE run)")
    sums, other = {}, {}
    seen = {kid: 0 for kid in _BY_SHAPE}
    for e in kernels:
        us = e.time_range.elapsed_us()
        kid = next((k for frag, k in _KERNEL_NAMES if frag in e.name), None)
        if kid in seen:
            i = seen[kid]
            kid = f"{kid} {classes[kid][i] if i < len(classes[kid]) else 'unmatched'}"
            seen[kid.split()[0]] += 1
        if kid is None:
            n, t = other.get(e.name, (0, 0.0))
            other[e.name] = (n + 1, t + us)
            continue
        n, t = sums.get(kid, (0, 0.0))
        sums[kid] = (n + 1, t + us)
    _require(all(seen[k] == len(classes[k]) for k in seen),
             f"profiler {label}: one K1/K4s/K4 kernel per wrapper launch")
    k3_kernels = sums.get("K3", (0, 0.0))[0]
    print(f"profile 24MP {label}: {k3_kernels} psf_grad kernels, K3 launches {counts['K3']}")
    _require(k3_kernels == counts["K3"], f"profiler {label}: one psf_grad kernel per K3 call")
    report = {k: {"launches": n, "device_s": t / 1e6} for k, (n, t) in sorted(sums.items())}
    print(f"profile 24MP {label} kernels: " + json.dumps(report))
    fft = [(n, t) for name, (n, t) in other.items() if "fft" in name.lower()]
    fft_s = sum(t for _, t in fft) / 1e6
    print(f"profile 24MP {label}: cuFFT {fft_s:.4f} s in {sum(n for n, _ in fft)} kernels, "
          f"{fft_s / busy:.3f} of the device time")
    top = sorted(other.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, t) in top:
        print(f"  other: {t / 1e6:.4f} s, {n} launches, {name[:100]}")
    print(f"  other total: {sum(t for _, t in other.values()) / 1e6:.4f} s")


# ---------------------------------------------------------------- phase 6
def _cli(argv, device="cuda") -> tuple[float, dict]:
    """Run the port's command line; (wall seconds, launches in the run)."""
    from ics_tpu_torch.cli import main as cli_main

    _zero_counters()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv, device=device)
    wall = time.perf_counter() - t0
    _require(rc == 0, f"{' '.join(argv[:1])} on {device} exits 0")
    return wall, _counters()


def phase_cli(pic19, outs19, pic24) -> dict:
    import tempfile

    from ics_tpu_torch.utils.io import imread, imsave

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "out")
        # the 24 MP scene as a 16-bit RGB TIFF, each filter with its defaults
        frame = os.path.join(tmp, "frame24.tif")
        imsave(frame, pic24.astype(np.uint16) * 257)
        for cmd, names in [("bilateral", ("K6",)), ("bilateral-lab", ("K6",)),
                           ("usm", ("K1",)), ("tv-denoise", ())]:
            wall, counts = _cli([cmd, frame, out_dir])
            out = imread(os.path.join(out_dir, f"frame24-{cmd}.tif"))
            print(f"CLI {cmd} 24MP 4000x6000, TIFF in and out: wall {wall:.3f} s, "
                  f"launches {json.dumps(counts)}")
            _require(out.dtype == np.uint16 and out.shape == pic24.shape,
                     f"CLI {cmd} writes a uint16 TIFF of the input's shape")
            _require(all(counts[n] > 0 for n in names),
                     f"{', '.join(names) or 'no kernel'} launched by the 24 MP CLI {cmd}")
            if cmd == "bilateral":
                launches["K6"] = counts["K6"]

        # deblur on the 1.9 MP scene, as an 8-bit TIFF, with phase 4's flags,
        # once per solver
        src = os.path.join(tmp, "scene19.tif")
        imsave(src, pic19)
        for solver, out19 in outs19.items():
            wall, counts = _cli(["deblur", src, out_dir, "--blur-width", "7", "--mask", "584",
                                 "795", "--tolerance", "0.1", "--solver", solver])
            got = imread(os.path.join(out_dir, "scene19-deblurred.tif"))
            print(f"CLI deblur --solver {solver} 1.9MP 1367x1394: wall {wall:.3f} s, "
                  f"launches {json.dumps(counts)}")
            names = SOLVER_KERNELS.get(solver, ("K1", "K2"))
            _require(all(counts[n] > 0 for n in names),
                     f"{', '.join(names)} launched by the CLI deblur --solver {solver}")
            _require(got.dtype == np.uint16 and np.array_equal(got, out19),
                     f"CLI deblur --solver {solver} TIFF bitwise equal to phase 4's array")

        # crop scale: the CLI on CUDA against the CLI on the CPU
        crop = os.path.join(tmp, "crop.tif")
        imsave(crop, make_scene(257, 263, 5, seed=3)[1])
        for cmd in ("bilateral", "bilateral-lab"):
            outs = {}
            for device in ("cuda", "cpu"):
                _cli([cmd, crop, os.path.join(tmp, device)], device=device)
                outs[device] = imread(os.path.join(tmp, device, f"crop-{cmd}.tif"))
            diff = int(np.abs(outs["cuda"].astype(np.int32) - outs["cpu"]).max())
            print(f"CLI {cmd} crop 257x263 cuda vs cpu: max difference {diff} codes")
            _require(diff <= 1, f"CLI {cmd} on CUDA within one 16-bit code of the CPU")
    return launches


# ---------------------------------------------------------------- phase 7
def _gauss_psf(blur: int) -> np.ndarray:
    """``make_scene``'s Gaussian PSF of width ``blur``, as a (blur, blur, 3)
    kernel."""
    k1 = selftest._gauss_taps(blur)
    return np.dstack([np.outer(k1, k1)] * 3).astype(np.float32)


def _ssim(a: np.ndarray, b: np.ndarray) -> tuple[float, bool]:
    """(SSIM of two uint16 arrays on the CPU, bitwise equal); equal arrays
    have SSIM 1 without the host filters (about 12 s at 24 MP)."""
    from ics_tpu_torch.utils import metrics

    if np.array_equal(a, b):
        return 1.0, True
    return metrics.ssim(a / 65535.0, b / 65535.0, device="cpu"), False


def _device_seconds(torch, prof) -> float:
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6


def _batch_runs(torch, dev, imgs, us, psfs, window):
    """(a): the burst through batched_deconvolve, 'map' then 'vmap', each
    under torch.profiler with the counters zeroed just before it; every
    'map' lane against a single richardson_lucy_MM call.  'map' runs its
    lanes in the host loop here (a solve under the profiler takes it:
    models/rl_mm.py::_eager_loop), so the single calls, in the WHILE loop,
    hold the two loops against each other; 'vmap' runs the fold's loop,
    which stops on K7 too; (b) times the CLI's 'map' in the WHILE loop."""
    from torch.profiler import ProfilerActivity, profile

    from ics_tpu_torch.cli import batch_codes
    from ics_tpu_torch.models.rl_mm import richardson_lucy_MM
    from ics_tpu_torch.parallel import batched_deconvolve

    kw = dict(tau=0.01, iterations=200, step_factor=1e-3, lambd=10000.0, blind=False)
    runs = {}
    for schedule in ("map", "vmap"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counters()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the host loop
            t0 = time.perf_counter()
            u_b, _, stats_b = batched_deconvolve(imgs, us, psfs, *window, schedule=schedule,
                                                 device=dev, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = _counters()
        outers = [int(n) for n in stats_b[:, 0].tolist()]
        device_s = _device_seconds(torch, prof)
        print(f"burst 4x24MP '{schedule}' (profiled, no WHILE launch): wall {wall:.3f} s, "
              f"per-lane outers {outers}, "
              f"device {device_s:.3f} s, {device_s / sum(outers) * 1e3:.3f} ms device time per "
              f"outer per lane, peak {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB, "
              f"launches {json.dumps(counts)}")
        runs[schedule] = (u_b, outers, counts)
    (u_map, outers_map, k_map), (u_vmap, outers_vmap, k_vmap) = runs["map"], runs["vmap"]
    _require(k_map["K1"] == 10 * sum(outers_map) and k_vmap["K1"] > 0,
             "burst: K1 launched 10 times per outer of every 'map' lane, and under 'vmap'")
    _require(k_vmap["K1"] <= 10 * max(outers_vmap),
             f"burst 'vmap': {k_vmap['K1']} K1 launches <= 10 x the largest lane's "
             f"{max(outers_vmap)} outers (one launch per conv for all lanes)")
    for i in range(len(imgs)):
        single = richardson_lucy_MM(imgs[i], us[i], psfs[i], *window, verbose=False, device=dev,
                                    **kw)
        _require(single.iterations == outers_map[i] and torch.equal(single.u, u_map[i]),
                 f"burst lane {i}: 'map' bitwise equal to one richardson_lucy_MM call, "
                 f"{single.iterations} outers")
        del single
    codes = {k: batch_codes(u) for k, u in (("map", u_map), ("vmap", u_vmap))}
    del u_map, u_vmap, runs
    for i in range(len(imgs)):
        s, same = _ssim(codes["vmap"][i], codes["map"][i])
        print(f"burst lane {i}: 'vmap' {outers_vmap[i]} outers, 'map' {outers_map[i]}; SSIM "
              f"{s:.7f}, bitwise equal {same}")
        _require(s >= 0.999, f"burst lane {i}: 'vmap' SSIM >= 0.999 against 'map'")
    return codes["map"]


def _mesh_rank(rank: int, port: int, tmp: str) -> None:
    """(c) and (d) on one of two gloo ranks sharing cuda:0: the 24 MP
    deblur_module(mesh=...), then two sharded_richardson_lucy calls at the
    final level's shape."""
    import torch
    import torch.distributed as dist

    from ics_tpu_torch import deblur_module
    from ics_tpu_torch.parallel import initialize, make_mesh, sharded_richardson_lucy

    initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo", device="cuda")
    try:
        mesh = make_mesh(2)
        pic = np.load(os.path.join(tmp, "pic24.npy"))
        stats = []
        _zero_counters()
        t0 = time.perf_counter()
        out = deblur_module(pic, "smoke", None, mesh=mesh, stats_out=stats, device="cuda",
                            **bench.KW24)
        wall = time.perf_counter() - t0
        counts = _counters()
        blind = {f"blind_psf{i}": s["result"].psf.cpu().numpy()
                 for i, s in enumerate(x for x in stats if x["case"] == "blind")}
        levels = np.array([s["result"].iterations for s in stats])
        image, u, psf = (np.load(os.path.join(tmp, f"d_{k}.npy")) for k in ("image", "u", "psf"))
        window = np.load(os.path.join(tmp, "d_window.npy")).tolist()
        calls, walls = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls.append(sharded_richardson_lucy(image, u, psf, *window, 1e9, mesh=mesh,
                                                 iterations=10, step_factor=1e-3,
                                                 lambd=10000.0, blind=False))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        repro = all(torch.equal(getattr(calls[0], k), getattr(calls[1], k))
                    for k in ("u", "u_full", "psf", "stats"))
        # a window wholly in rank 1's rows: rank 0 sends none of it
        low = sharded_richardson_lucy(image, u, psf, *np.load(os.path.join(tmp, "d_low.npy")),
                                      1e9, mesh=mesh, iterations=10, step_factor=1e-3,
                                      lambd=10000.0, blind=False)
        np.savez(os.path.join(tmp, f"mesh_r{rank}.npz"), out=out, levels=levels, wall=wall,
                 k1=counts["K1"], k2=counts["K2"], k3=counts["K3"], d_walls=np.array(walls),
                 d_repro=repro, d_stats=calls[0].stats.cpu().numpy(),
                 low_stats=low.stats.cpu().numpy(),
                 **({"d_u": calls[0].u.cpu().numpy(), "low_u": low.u.cpu().numpy()}
                    if rank == 0 else {}), **blind)
    finally:
        dist.destroy_process_group()


def phase_parallel(torch, dev, pic19, out19, pic24, exact24, burst_dir: str) -> None:
    """7. batching and many ranks: (a) a burst of four 24 MP frames through
    batched_deconvolve, 'map' and 'vmap'; (b) the CLI deblur-batch on them,
    alone and with --shard 1 (one NCCL rank); (c) the 24 MP deblur_module
    on two gloo ranks sharing cuda:0; (d) sharded_richardson_lucy at the
    24 MP final level's shape; (e) deblur --shard 1 at 1.9 MP."""
    import tempfile

    import torch.multiprocessing as mp

    from ics_tpu_torch.cli import _free_port, batch_inputs
    from ics_tpu_torch.models.checkpoint import SolverCheckpoint, save_checkpoint
    from ics_tpu_torch.models.rl_mm import richardson_lucy_MM
    from ics_tpu_torch.utils.io import imread, imsave

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the burst, as 16-bit frames, through the CLI's own preprocessing
        frames = np.stack([make_scene(4000, 6000, 9, seed=i)[1].astype(np.uint16) * 257
                           for i in range(4)])
        psf = _gauss_psf(9)
        imgs, us, psfs, window = batch_inputs(frames, psf, None, 511)
        codes_map = _batch_runs(torch, dev, imgs, us, psfs, window)
        del imgs, us, psfs

        # (b) the CLI on the same frames, TIFF in and out
        for i, frame in enumerate(frames):
            imsave(os.path.join(burst_dir, f"burst{i}.tif"), frame)
        del frames
        ckpt = os.path.join(tmp, "psf.npz")
        save_checkpoint(ckpt, SolverCheckpoint(psf=psf, blur_width=9))
        outs = {}
        for extra in ([], ["--shard", "1"]):
            dest = os.path.join(tmp, f"batch{len(extra)}")
            wall, counts = _cli(["deblur-batch", os.path.join(burst_dir, "burst*.tif"), dest, "--psf",
                                 ckpt, "--mask-size", "511", *extra])
            outs[len(extra)] = np.stack([imread(os.path.join(dest, f"burst{i}-deblurred.tif"))
                                         for i in range(4)])
            print(f"CLI deblur-batch 4x24MP {' '.join(extra) or '(one process)'}: wall "
                  f"{wall:.3f} s, launches in this process {json.dumps(counts)}")
        _require(np.array_equal(outs[0], outs[2]),
                 "CLI deblur-batch TIFFs bitwise equal with and without --shard 1 (NCCL)")
        _require(np.array_equal(outs[0], codes_map),
                 "CLI deblur-batch TIFFs bitwise equal to the library's 'map' run")
        del outs, codes_map

        # (c) and (d) on two gloo ranks sharing cuda:0
        np.save(os.path.join(tmp, "pic24.npy"), pic24)
        # the final level's frame: the odd-padded 4003x6003 plus the safety ring
        image = np.pad(pic24.astype(np.float32) / 255.0, ((3, 2), (3, 2), (0, 0)), mode="edge")
        u = np.pad(image, ((4, 4), (4, 4), (0, 0)), mode="edge")
        d_window = [5, 506, 5, 506]  # the final level's mask box, as the pipeline makes it
        d_low = [3200, 3711, 2745, 3256]  # a mask in the lower half: rank 1's rows only
        for k, v in (("image", image), ("u", u), ("psf", psf), ("window", np.array(d_window)),
                     ("low", np.array(d_low))):
            np.save(os.path.join(tmp, f"d_{k}.npy"), v)
        single, single_low = (richardson_lucy_MM(image, u, psf, *w, 1e9, iterations=10,
                                                 step_factor=1e-3, lambd=10000.0, blind=False,
                                                 verbose=False, device=dev)
                              for w in (d_window, d_low))
        t0 = time.perf_counter()
        mp.start_processes(_mesh_rank, args=(_free_port(), tmp), nprocs=2, join=True,
                           start_method="spawn")
        spawn_wall = time.perf_counter() - t0
        ranks = [dict(np.load(os.path.join(tmp, f"mesh_r{r}.npz"))) for r in range(2)]
        out24, levels24 = exact24
        s, same = _ssim(ranks[0]["out"], out24)
        print(f"24MP deblur_module on 2 gloo ranks sharing cuda:0: wall {float(ranks[0]['wall']):.3f}"
              f" / {float(ranks[1]['wall']):.3f} s (one device, phase 5: see above), outers per "
              f"level {ranks[0]['levels'].tolist()} against {[n for _, _, n, _ in levels24]}, "
              f"K1/K2/K3 on rank 0 {int(ranks[0]['k1'])}/{int(ranks[0]['k2'])}/"
              f"{int(ranks[0]['k3'])}; SSIM against one device {s:.7f}, bitwise equal "
              f"{same}; both ranks started and ran in "
              f"{spawn_wall:.1f} s")
        _require(np.array_equal(ranks[0]["out"], ranks[1]["out"]),
                 "24 MP mesh: the two ranks' arrays bitwise equal")
        blind_keys = [k for k in ranks[0] if k.startswith("blind_psf")]
        _require(blind_keys and all(np.array_equal(ranks[0][k], ranks[1][k]) for k in blind_keys),
                 "24 MP mesh: the two ranks' blind PSFs bitwise equal")
        _require(s >= 0.999, "24 MP mesh: SSIM >= 0.999 against phase 5's one-device array")
        _require(int(ranks[0]["k1"]) > 0 and int(ranks[0]["k3"]) > 0,
                 "24 MP mesh: K1 and K3 launched on each rank's path")
        d_err = float(np.abs(ranks[0]["d_u"] - single.u.cpu().numpy()).max())
        st_err = float(np.abs(ranks[0]["d_stats"] - single.stats.cpu().numpy()).max())
        print(f"sharded_richardson_lucy 4005x6005 mk 9, 10 outers, 2 gloo ranks: calls "
              f"{ranks[0]['d_walls'].round(3).tolist()} s; u against one device {d_err:.3e}, "
              f"stats {st_err:.3e}")
        _require(d_err <= 5e-5 and st_err <= 1e-6,
                 "sharded solve at 24 MP: u within 5e-5 and stats within 1e-6 of one device")
        _require(all(bool(r["d_repro"]) for r in ranks)
                 and np.array_equal(ranks[0]["d_stats"], ranks[1]["d_stats"]),
                 "sharded solve at 24 MP: bitwise reproducible, the same stats on both ranks")
        low_err = float(np.abs(ranks[0]["low_u"] - single_low.u.cpu().numpy()).max())
        low_st = float(np.abs(ranks[0]["low_stats"] - single_low.stats.cpu().numpy()).max())
        print(f"sharded_richardson_lucy, mask rows {d_low[0]}-{d_low[1]} (rank 1's only): u "
              f"against one device {low_err:.3e}, stats {low_st:.3e}")
        _require(low_err <= 5e-5 and low_st <= 1e-6
                 and np.array_equal(ranks[0]["low_stats"], ranks[1]["low_stats"]),
                 "sharded solve at 24 MP, mask in one rank's rows: u within 5e-5 and stats "
                 "within 1e-6 of one device, the same stats on both ranks")
        del ranks, single, single_low

        # (e) deblur --shard 1 at 1.9 MP (one NCCL rank)
        src = os.path.join(tmp, "scene19.tif")
        imsave(src, pic19)
        dest = os.path.join(tmp, "shard1")
        wall, _ = _cli(["deblur", src, dest, "--blur-width", "7", "--mask", "584", "795",
                        "--tolerance", "0.1", "--shard", "1"])
        got = imread(os.path.join(dest, "scene19-deblurred.tif"))
        s, same = _ssim(got, out19)
        print(f"CLI deblur --shard 1 1.9MP: wall {wall:.3f} s, SSIM against phase 4 {s:.7f}, "
              f"bitwise equal {same}")
        _require(got.shape == out19.shape and s >= 0.999,
                 "CLI deblur --shard 1 SSIM >= 0.999 against phase 4's array")
    print(f"phase 7: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- phase 8
def _python_coder(task: str, data: bytes, expected: int) -> tuple[str, float, int]:
    """One pure-Python TIFF coder call in a worker process: (sha256 of its
    output, seconds, output bytes)."""
    import hashlib

    from ics_tpu_torch.utils import io as tio

    coder = {"lzw encode": tio._encode_lzw_py, "packbits encode": tio._encode_packbits_py,
             "lzw decode": tio._decode_lzw_py, "packbits decode": tio._decode_packbits_py}[task]
    t0 = time.perf_counter()
    out = coder(data, expected) if task.endswith("decode") else coder(data)
    seconds = time.perf_counter() - t0
    return hashlib.sha256(out).hexdigest(), seconds, len(out)


def _native_coders(frame16: np.ndarray, pool):
    """(a) The native LZW and PackBits coders on the 24 MP scene as 16-bit
    RGB, timed; starts the pure-Python coders on the same bytes in ``pool``
    (four worker processes, one core each) and returns a function that
    checks their bytes against the native ones."""
    import hashlib

    from ics_tpu_torch.runtime import codecs, loader

    _require(codecs.available() and loader.available(),
             "native runtime: codecs.available() and loader.available()")
    data = frame16.astype("<u2").tobytes()
    native = {}
    for coder in ("lzw", "packbits"):
        t0 = time.perf_counter()
        enc = getattr(codecs, f"encode_{coder}")(data)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        dec = getattr(codecs, f"decode_{coder}")(enc, len(data))
        t_dec = time.perf_counter() - t0
        print(f"native {coder} 24MP 16-bit RGB ({len(data)} bytes): encode {t_enc:.3f} s "
              f"({len(enc)} bytes), decode {t_dec:.3f} s")
        _require(dec == data, f"native {coder} decodes the 24 MP frame back")
        native[coder] = (enc, hashlib.sha256(enc).hexdigest())
    want = hashlib.sha256(data).hexdigest()
    jobs = {
        task: pool.apply_async(_python_coder, (task, native[task.split()[0]][0]
                                               if "decode" in task else data, len(data)))
        for task in ("lzw encode", "lzw decode", "packbits encode", "packbits decode")
    }
    del data

    def finish():
        for task, job in jobs.items():
            digest, seconds, n = job.get()
            coder = task.split()[0]
            print(f"python {task} 24MP: {seconds:.3f} s ({n} bytes; one process, while "
                  f"the phase ran on the card)")
            if task.endswith("encode"):
                _require(digest == native[coder][1],
                         f"native {coder} bytes equal the pure-Python coder's at 24 MP")
            else:
                _require(digest == want, f"python {coder} decodes the 24 MP frame back")

    return finish


def _evict(paths) -> None:
    """Drop the files' pages from the page cache (after an fsync, so that
    every page is clean), so that the next read comes from the disk."""
    for path in paths:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def _sequence_reads(burst_dir: str) -> None:
    """(a) imread_sequence of phase 7's four 24 MP TIFFs, serial and through
    the native prefetcher, in turns, on cached files and then with each
    file's pages dropped from the page cache before every read."""
    import glob

    from ics_tpu_torch.utils.io import imread_sequence

    paths = sorted(glob.glob(os.path.join(burst_dir, "burst*.tif")))
    first, same = None, True
    for files in ("cached", "evicted"):
        walls = {True: [], False: []}
        for prefetch in (False, True, True, False):
            if files == "evicted":
                _evict(paths)
            t0 = time.perf_counter()
            stack = imread_sequence(paths, prefetch=prefetch)
            walls[prefetch].append(time.perf_counter() - t0)
            first = stack if first is None else first
            same = same and np.array_equal(stack, first)
            del stack
        print(f"imread_sequence 4x24MP 16-bit TIFFs, {files} files: prefetch=True "
              f"{walls[True]} s, prefetch=False {walls[False]} s (turns: serial, prefetch, "
              f"prefetch, serial)")
    _require(first.shape == (4, 4000, 6000, 3) and same,
             "imread_sequence with the prefetcher equals the serial read")


def _bilateral_split(frame16: np.ndarray) -> None:
    """(a) The CLI ``bilateral`` at 24 MP with the TIFF read, the filter and
    the TIFF write timed apart (each stage synchronizes the card)."""
    import tempfile

    import torch

    from ics_tpu_torch import cli
    from ics_tpu_torch.utils import io as tio

    spans = {"read": 0.0, "filter": 0.0, "write": 0.0}

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[name] += time.perf_counter() - t0
            return out
        return call

    originals = (tio.load_image, tio.save, cli._per_channel)
    tio.load_image, tio.save = timed("read", tio.load_image), timed("write", tio.save)
    cli._per_channel = timed("filter", cli._per_channel)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            frame = os.path.join(tmp, "frame24.tif")
            tio.imsave(frame, frame16)
            wall, counts = _cli(["bilateral", frame, tmp])
            out = tio.imread(os.path.join(tmp, "frame24-bilateral.tif"))
    finally:
        tio.load_image, tio.save, cli._per_channel = originals
    rest = wall - sum(spans.values())
    print(f"CLI bilateral 24MP split: wall {wall:.3f} s = TIFF read {spans['read']:.3f} s + "
          f"filter (3 K6 planes) {spans['filter']:.3f} s + TIFF write {spans['write']:.3f} s "
          f"+ rest (upload, scaling, download, argument parsing) {rest:.3f} s; "
          f"launches {json.dumps(counts)}")
    _require(counts["K6"] > 0 and out.shape == frame16.shape and out.dtype == np.uint16,
             "CLI bilateral 24MP: K6 launched, a uint16 TIFF of the input's shape")


def _batteries(dev) -> None:
    """(b) The success and precision-quality batteries, the conv bench and
    the scaling bench, each with the counters zeroed just before it."""
    _zero_counters()
    t0 = time.perf_counter()
    rate, rows = selftest.bench_success_rate(report=print, device=dev)
    counts = _counters()
    print(f"success battery: {time.perf_counter() - t0:.1f} s, rate {rate:.4f}, launches "
          f"{json.dumps(counts)}")
    _require(len(rows) == 12 and all(np.isfinite(r[1:5]).all() for r in rows),
             "success battery: 12 rows with finite errors and SSIMs")
    _require(counts["K1"] > 0 and counts["K2"] > 0, "success battery: K1 and K2 launched")

    _zero_counters()
    t0 = time.perf_counter()
    quality = selftest.bench_precision_quality(report=print, device=dev)
    counts = _counters()
    print(f"precision quality 24MP: {time.perf_counter() - t0:.1f} s, {json.dumps(quality)}, "
          f"launches {json.dumps(counts)}")
    _require(all(np.isfinite([quality[m]["ssim"], quality[m]["psnr"], quality[m]["ssim_vs_f32"]]).all()
                 and quality[m]["outers"] >= 1 for m in ("float32", "high", "mixed")),
             "precision quality 24MP: finite scores and at least one outer per mode")
    _require(all(counts[k] > 0 for k in ("K1", "K2", "K3", "K4s", "K4")),
             "precision quality 24MP: K1, K2, K3, K4s and K4 launched")

    _zero_counters()
    t0 = time.perf_counter()
    selftest.bench_conv_backends(report=print, device=dev, kernels=selftest.CONV_BENCH_KERNELS)
    counts = _counters()
    print(f"conv bench: {time.perf_counter() - t0:.1f} s, launches {json.dumps(counts)}")
    _require(all(counts[k] > 0 for k in ("K1", "K4s", "K4", "K4h", "K4d")),
             "conv bench: K1, K4s, K4, K4h and K4d launched")

    t0 = time.perf_counter()
    scaling = selftest.bench_scaling(ns=(1,), report=print, device=dev)
    print(f"scaling bench: {time.perf_counter() - t0:.1f} s")
    _require(set(scaling) == {1} and scaling[1] > 0, "scaling bench: one NCCL rank ran")


def _examples() -> None:
    """(c) The four examples on 512^2 make_scene TIFFs, counters zeroed
    before each; shard_deblur on one NCCL rank."""
    import tempfile

    from ics_tpu_torch.examples import (chroma_denoise, deblur_cases, hsv_color_balance,
                                        shard_deblur)
    from ics_tpu_torch.utils.io import imread, imsave

    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "scene512.tif")
        imsave(scene, make_scene(512, 512, 5, seed=512)[1])
        runs = [
            ("deblur_cases", lambda: deblur_cases.main(
                ["crop", "--input", scene, "--dest", os.path.join(tmp, "dc")]),
             [os.path.join(tmp, "dc", "crop-blured-v1.tif")], (512, 512, 3), ("K1", "K2")),
            ("chroma_denoise", lambda: chroma_denoise.main([scene, os.path.join(tmp, "cd")]),
             [os.path.join(tmp, "cd", f"{n}.tif.tif")
              for n in ("noisy", "channel", "collab", "collab_l2")], (256, 256, 3), ("K1", "K5")),
            ("hsv_color_balance", lambda: hsv_color_balance.main([scene, os.path.join(tmp, "hsv")]),
             [os.path.join(tmp, "hsv", "scene512-hue-shift.tif")], (512, 512, 3), ()),
            ("shard_deblur --shard 1", lambda: shard_deblur.main(
                [scene, os.path.join(tmp, "sd"), "--shard", "1", "--blur-width", "5"]),
             [os.path.join(tmp, "sd", "scene512-sharded.tif")], (512, 512, 3), ()),
        ]
        for name, run, outputs, shape, kernels in runs:
            _zero_counters()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = run()
            wall = time.perf_counter() - t0
            counts = _counters()
            print(f"example {name} on a 512x512 scene: wall {wall:.3f} s, launches in this "
                  f"process {json.dumps(counts)}")
            _require(rc == 0, f"example {name} exits 0")
            for path in outputs:
                out = imread(path) if os.path.exists(path) else None
                _require(out is not None and out.dtype == np.uint16 and out.shape == shape
                         and np.isfinite(out).all() and out.max() > 0,
                         f"example {name}: {os.path.basename(path)} is a uint16 TIFF of shape "
                         f"{shape}")
            _require(all(counts[k] > 0 for k in kernels),
                     f"example {name}: {', '.join(kernels) or 'no kernel'} launched")


def phase_host_and_batteries(torch, dev, pic24, burst_dir: str) -> None:
    """8. (a) the native runtime: build at first use, the LZW and PackBits
    coders at 24 MP against the pure-Python coders, imread_sequence with and
    without the prefetcher, the CLI bilateral's read, filter and write
    apart; (b) the batteries and benches of utils.selftest; (c) the four
    examples."""
    import multiprocessing

    t_phase = time.perf_counter()
    frame16 = pic24.astype(np.uint16) * 257
    # the pool's context manager terminates the workers, on a failure too
    with multiprocessing.get_context("spawn").Pool(4) as pool:
        finish_python_coders = _native_coders(frame16, pool)
        _sequence_reads(burst_dir)
        _bilateral_split(frame16)
        del frame16
        print(f"phase 8 (a) on the card: {time.perf_counter() - t_phase:.1f} s")
        _batteries(dev)
        print(f"phase 8 (b): {time.perf_counter() - t_phase:.1f} s")
        _examples()
        t0 = time.perf_counter()
        finish_python_coders()
    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s ({time.perf_counter() - t0:.1f} s "
          f"waiting for the pure-Python coders at the end)")


# ---------------------------------------------------------------- phase 9
def _rl(torch, dev, pic, mk, blind=False, window=None, tau=1e9, iterations=20, solver="mm",
        **cfg):
    """``richardson_lucy_MM`` (``solver`` 'pam' or 'pd': their solvers, with
    their default configurations) on the uint8 frame ``pic`` (or its
    ``window``: top, left, rows, columns) with the scene's mk x mk Gaussian
    PSF, by default 20 outers (tau 1e9: the non-blind stop never fires);
    (result, launches, seconds), the counters zeroed just before the run."""
    from ics_tpu_torch.models.rl_mm import RLConfig, richardson_lucy_MM
    from ics_tpu_torch.models.rl_pam import richardson_lucy_PAM
    from ics_tpu_torch.models.rl_pd import richardson_lucy_PD

    if window is not None:
        top, left, rows, cols = window
        pic = pic[top : top + rows, left : left + cols]
    img = pic.astype(np.float32) / 255.0
    pad = mk // 2
    u0 = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    m, n = img.shape[:2]
    box = (m // 2 - 255, m // 2 + 256, n // 2 - 255, n // 2 + 256) if m > 600 else \
        (pad + 1, m - pad - 1, pad + 1, n - pad - 1)
    image, u0 = torch.from_numpy(img).to(dev), torch.from_numpy(u0).to(dev)
    torch.cuda.synchronize(dev)
    _zero_counters()
    t0 = time.perf_counter()
    fn = {"mm": richardson_lucy_MM, "pam": richardson_lucy_PAM, "pd": richardson_lucy_PD}[solver]
    res = fn(image, u0, _gauss_psf(mk), *box, tau, iterations=iterations, blind=blind,
             config=RLConfig(**cfg) if solver == "mm" else None, device=dev)
    torch.cuda.synchronize(dev)
    return res, _counters(), time.perf_counter() - t0


def _u_rel(torch, got, ref) -> float:
    return float(torch.max(torch.abs(got.u - ref.u)) / torch.max(torch.abs(ref.u)))


def _finite(torch, res) -> bool:
    return bool(torch.isfinite(res.u).all())


# the blind 1.9 MP window solve, 'pallas_mxu' exact (K4h) against 'auto'
# (K1), both through the op loop: u and PSF gaps relative to their largest
# values after 20 outers, between K4h's readings on an H100 (1.3e-7, 1.7e-6)
# and K4s's or K4d's in its place (3e-5 or more, 1e-2 or more)
BLIND_U_TOL, BLIND_PSF_TOL = 1e-6, 1e-5


def _recording(seen: set):
    """Wraps K4h's and K4d's wrappers so that each call adds (wrapper, a's
    shape, k's shape, mode) to ``seen``; returns the function that restores
    them.  ops/conv.py reads the wrappers from the module at each call."""
    from ics_tpu_torch.ops import cuda_conv_mma

    originals = {n: getattr(cuda_conv_mma, n) for n in ("conv_highest", "conv_default")}

    def wrap(name, fn):
        def call(a, k, mode):
            seen.add((name, tuple(a.shape), tuple(k.shape), mode))
            return fn(a, k, mode)
        return call

    for name, fn in originals.items():
        setattr(cuda_conv_mma, name, wrap(name, fn))
    return lambda: [setattr(cuda_conv_mma, n, fn) for n, fn in originals.items()]


def _check_seen(torch, dev, seen: set) -> None:
    """K4h and K4d against their twins at every shape the phase gave them,
    on uniform inputs, at the certification's bounds, and bitwise
    reproducible; these launches come after the phase's counts were read."""
    from ics_tpu_torch.ops import cuda_conv_mma
    from ics_tpu_torch.utils.selftest import _Certify

    tols = {fn: tol for fn, _, tol, _, _ in _Certify.K4_VARIANTS.values()}
    gen = torch.Generator(device=dev).manual_seed(9)
    for name, a_shape, k_shape, mode in sorted(seen):
        a = torch.rand(a_shape, device=dev, generator=gen) * 0.75 + 0.15
        k = torch.rand(k_shape, device=dev, generator=gen) * 0.95 + 0.05
        kern, plain = getattr(cuda_conv_mma, name), getattr(cuda_conv_mma, f"{name}_plain")
        got, again = kern(a, k, mode), kern(a, k, mode)
        ref = plain(a, k, mode)
        rel = float(torch.max(torch.abs(got - ref)) / torch.max(torch.abs(ref)))
        label = f"phase 9 shape {name} {a_shape} taps {k_shape[1:]} {mode}"
        print(f"{label}: rel {rel:.3e} against its twin")
        _require(rel <= tols[name], f"{label} within {tols[name]:g} of its twin")
        _require(torch.equal(got, again), f"{label} bitwise reproducible")
        del a, k, got, again, ref


def phase_conv_methods(torch, dev, pic19, pic24) -> dict:
    """Phase 9: ``RLConfig.conv_method`` on the card.  Returns the launches
    of K4h (the 24 MP 'pallas_mxu' exact run) and K4d (its 'fast' run).
    Every shape the runs give K4h and K4d is then certified against the
    twins."""
    t_phase = time.perf_counter()
    seen = set()
    restore = _recording(seen)
    try:
        launches = _conv_method_runs(torch, dev, pic19, pic24)
    finally:
        restore()
    _check_seen(torch, dev, seen)
    seconds = time.perf_counter() - t_phase
    print(f"phase 9: {seconds:.1f} s")
    _require(seconds <= 60.0, "phase 9 takes at most 60 s")
    return launches


def _run_device_seconds(torch, dev, pic24, kid: str, first, **cfg) -> None:
    """The 24 MP 20-outer run of ``cfg`` again, counting the launches of
    ``kid`` (K4h or K4d) by shape: its device seconds in the run are each
    shape's launches times that shape's device time alone
    (``selftest._median_ms``, the card kept busy ahead of each timed call;
    the kernel's time does not depend on the data).  The run must give
    ``first``'s u.  (torch.profiler missed a few of these kernels now and
    then, so it does not count them here.)"""
    from ics_tpu_torch.ops import cuda_conv_mma

    name = {"K4h": "conv_highest", "K4d": "conv_default"}[kid]
    inner = getattr(cuda_conv_mma, name)
    shapes = collections.Counter()

    def counted(a, k, mode):
        _note(lambda key, n: shapes.update({key: n}), (tuple(a.shape), tuple(k.shape), mode))
        return inner(a, k, mode)

    setattr(cuda_conv_mma, name, counted)
    try:
        with _replays_noted():
            again, counts, _ = _rl(torch, dev, pic24, 9, **cfg)
    finally:
        setattr(cuda_conv_mma, name, inner)
    gen = torch.Generator(device=dev).manual_seed(7)
    seconds, parts = 0.0, []
    for (a_shape, k_shape, mode), n in sorted(shapes.items()):
        a = torch.rand(a_shape, device=dev, generator=gen)
        k = torch.rand(k_shape, device=dev, generator=gen)
        ms = selftest._median_ms(torch, lambda: inner(a, k, mode), 5, device_only=True)
        seconds += n * ms / 1e3
        parts.append(f"{n} x {a_shape} {mode} at {ms:.4f} ms")
        del a, k
    label = f"24MP {' '.join(map(str, cfg.values()))}"
    print(f"phase 9: {label}: {kid} {seconds:.4f} device s in the run ({'; '.join(parts)})")
    _require(sum(shapes.values()) == counts[kid] > 0 and torch.equal(again.u, first.u),
             f"{label} again: every {kid} launch counted by shape, the same u")


def _conv_method_runs(torch, dev, pic19, pic24) -> dict:
    from ics_tpu_torch.utils import metrics

    launches = {}
    ref, counts, wall = _rl(torch, dev, pic24, 9)
    print(f"phase 9: 24MP non-blind 20 outers 'auto': {wall:.3f} s, launches {json.dumps(counts)}")
    _require(counts["K1"] > 0 and _finite(torch, ref), "24 MP 'auto' runs K1, u finite")
    got, counts, wall = _rl(torch, dev, pic24, 9, conv_method="pallas_mxu")
    rel = _u_rel(torch, got, ref)
    print(f"phase 9: 24MP 'pallas_mxu' exact: {wall:.3f} s, launches {json.dumps(counts)}, "
          f"u rel {rel:.3e} against 'auto'")
    _require(counts["K4h"] > 0 and counts["K1"] == 0,
             "24 MP 'pallas_mxu' exact launches K4h and not K1")
    _require(rel <= 1e-5, "24 MP 'pallas_mxu' exact u within 1e-5 of 'auto'")
    launches["K4h"] = counts["K4h"]
    _run_device_seconds(torch, dev, pic24, "K4h", got, conv_method="pallas_mxu")
    got, counts, wall = _rl(torch, dev, pic24, 9, conv_method="pallas_mxu",
                            conv_precision="fast")
    s = metrics.ssim(got.u.cpu().numpy(), ref.u.cpu().numpy(), device="cpu")
    print(f"phase 9: 24MP 'pallas_mxu' fast: {wall:.3f} s, launches {json.dumps(counts)}, "
          f"u rel {_u_rel(torch, got, ref):.3e}, SSIM against 'auto' {s:.7f} (CPU)")
    _require(counts["K4d"] > 0 and counts["K1"] == 0,
             "24 MP 'pallas_mxu' fast launches K4d and not K1")
    _require(s >= 0.999, "24 MP 'pallas_mxu' fast SSIM >= 0.999 against 'auto'")
    launches["K4d"] = counts["K4d"]
    _run_device_seconds(torch, dev, pic24, "K4d", got, conv_method="pallas_mxu",
                        conv_precision="fast")
    del ref, got

    # the 1.9 MP case's blind mask window (255^2 around [584, 795]), op loop
    window = (584 - 127, 795 - 127, 255, 255)
    blind_ref, counts, _ = _rl(torch, dev, pic19, 7, blind=True, window=window,
                               inner_loop="xla")
    got, counts, wall = _rl(torch, dev, pic19, 7, blind=True, window=window,
                            inner_loop="xla", conv_method="pallas_mxu")
    u_rel = _u_rel(torch, got, blind_ref)
    psf_rel = float(torch.max(torch.abs(got.psf - blind_ref.psf)) / torch.max(blind_ref.psf))
    print(f"phase 9: 1.9MP blind 255^2 window 'pallas_mxu', inner_loop='xla': {wall:.3f} s, "
          f"launches {json.dumps(counts)}, u rel {u_rel:.3e} and psf rel {psf_rel:.3e} "
          "against 'auto'")
    _require(counts["K4h"] > 0 and counts["K3"] > 0 and _finite(torch, got),
             "1.9 MP blind 'pallas_mxu' with inner_loop='xla' launches K4h and K3")
    _require(u_rel <= BLIND_U_TOL and psf_rel <= BLIND_PSF_TOL,
             f"1.9 MP blind 'pallas_mxu' u within {BLIND_U_TOL:g} and psf within "
             f"{BLIND_PSF_TOL:g} of 'auto'")
    # 'high' under an explicit method is 'exact', as JAX's _dispatch has it
    high, counts, wall = _rl(torch, dev, pic19, 7, blind=True, window=window,
                             inner_loop="xla", conv_method="pallas_mxu", conv_precision="high")
    same = torch.equal(high.u, got.u) and torch.equal(high.psf, got.psf)
    print(f"phase 9: 1.9MP blind 255^2 window 'pallas_mxu' high: {wall:.3f} s, launches "
          f"{json.dumps(counts)}, bitwise the exact run: {same}")
    _require(counts["K4h"] > 0 and counts["K4s"] == 0,
             "1.9 MP blind 'pallas_mxu' high launches K4h and no K4s")
    _require(same, "1.9 MP blind 'pallas_mxu' high equals 'pallas_mxu' exact bit for bit")
    del high, got

    # every other method, non-blind at 1.9 MP, against 'auto'
    ref, _, _ = _rl(torch, dev, pic19, 7)
    routes = {"direct": (), "fft": (), "stencil": ("K1",), "pallas": ("K1",), "mxu": ("K4h",)}
    for method, names in routes.items():
        got, counts, wall = _rl(torch, dev, pic19, 7, conv_method=method)
        rel = _u_rel(torch, got, ref)
        print(f"phase 9: 1.9MP non-blind '{method}': {wall:.3f} s, launches "
              f"{json.dumps(counts)}, u rel {rel:.3e} against 'auto'")
        conv_kernels = ("K1", "K4s", "K4", "K4h", "K4d")
        _require(all((counts[n] > 0) == (n in names) for n in conv_kernels),
                 f"1.9 MP '{method}' launches "
                 + (f"{', '.join(names)} and no other conv kernel" if names else
                    "no conv kernel (cuDNN or cuFFT)"))
        _require(rel <= 1e-5, f"1.9 MP '{method}' u within 1e-5 of 'auto'")
    return launches


# --------------------------------------------------------------- phase 10
def phase_bench(torch, dev, pic19, cases: dict) -> None:
    """``ics_tpu_torch.bench``'s pieces: ``_run_case`` on phase 4's 1.9 MP
    scene with its kwargs (K1 and K2 launched, phase 4's outer count), the
    per-outer probes at the 24 MP final level's geometry, 2 outers each,
    exact (K1) and 'high' (K4s), one more exact probe under torch.profiler
    (device time per outer by kernel), then the bench's JSON line assembled
    from these and phase 5's single 24 MP runs (``bench.KW24``), held to
    BENCH_r05.json's keys.  The counters are zeroed just before each and
    read just after."""
    t_phase = time.perf_counter()
    _zero_counters()
    case19 = bench._run_case(pic19, bench.KW19, "smoke-bench-1.9mp", reps=1, device=dev)
    counts = _counters()
    print(f"phase 10: bench 1.9MP: wall {case19[0]:.3f} s, compute-only {case19[2]:.3f} s, "
          f"{case19[1]} outers, launches {json.dumps(counts)}")
    _require(case19[1] == cases["1.9mp"][1],
             f"bench._run_case 1.9 MP: phase 4's {cases['1.9mp'][1]} outers")
    _require(counts["K1"] > 0 and counts["K2"] > 0, "bench 1.9 MP case launches K1 and K2")
    probes = {}
    for precision, kid in (("exact", "K1"), ("high", "K4s")):
        _zero_counters()
        probes[precision] = bench._per_outer_probe(iters=2, reps=1, conv_precision=precision,
                                                   device=dev)
        counts = _counters()
        per_outer = probes[precision][0]
        print(f"phase 10: per-outer probe {precision}: {per_outer * 1e3:.3f} ms per outer "
              f"(2 outers, best of 1), launches {json.dumps(counts)}")
        _require(np.isfinite(per_outer) and per_outer > 0 and counts[kid] > 0,
                 f"per-outer probe {precision}: finite stats, {kid} launched")
    # where the exact probe's time goes: one more call (a warm and a timed
    # solve of 2 outers each) under torch.profiler, in the host loop
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the host loop
        bench._per_outer_probe(iters=2, reps=1, device=dev)
    outers, sums = 4, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kid = next((k for frag, k in _KERNEL_NAMES if frag in e.name), e.name[:160])
            n, t = sums.get(kid, (0, 0.0))
            sums[kid] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    # the set-up's uploads of the frame and u, outside the probe's clock
    copies = [sums.pop(k) for k in [k for k in sums if k.startswith("Memcpy HtoD")]]
    busy = sum(t for _, t in sums.values())
    print(f"phase 10: exact probe profiled: set-up uploads {sum(t for _, t in copies):.3f} ms "
          f"in {sum(n for n, _ in copies)} copies; the solves' device busy "
          f"{busy / outers:.3f} ms per outer, {sum(n for n, _ in sums.values()) / outers:.1f} "
          "kernels per outer; by kernel, ms per outer, launches per outer, share:")
    for name, (n, t) in sorted(sums.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {t / outers:.3f} ms, {n / outers:.1f}, {t / busy:.3f}, {name}")
    _require(sums.get("K1", (0, 0.0))[0] > 0, "profiled exact probe: K1 in the trace")

    line = bench._result(4000 * 6000 / 1e6, cases["exact"], cases["mixed"], cases["high"],
                         probes["exact"], probes["high"], pic19.shape[0] * pic19.shape[1] / 1e6,
                         case19, bench._device_name(dev))
    numbers = [v for d in (line, *(v for v in line.values() if isinstance(v, dict)))
               for v in d.values() if isinstance(v, (int, float))]

    def keys(d, prefix=""):
        return {prefix + k for k in d} | {x for k, v in d.items() if isinstance(v, dict)
                                          for x in keys(v, prefix + k + ".")}

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "BENCH_r05.json")) as f:
        want = keys(json.load(f)["parsed"])
    _require(all(np.isfinite(numbers)) and keys(line) == want,
             "bench JSON line: every number finite, BENCH_r05.json's keys")
    print(f"phase 10: bench JSON line (phase 5's single 24 MP runs under bench.KW24, phase "
          f"10's 1.9 MP case and probes): {json.dumps(line)}")
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------- phase 11
WINDOW19 = (584 - 127, 795 - 127, 255, 255)  # the 1.9 MP case's mask window
WINDOW24 = (2000 - 256, 3000 - 256, 512, 512)  # 520^2 with mk 9: the op loop


def _same_bits(torch, a, b) -> bool:
    """Two RLResults bitwise: u, u_full (None for PAM and PD), psf, image,
    stats and the record."""
    same = all(getattr(a, n) is None and getattr(b, n) is None
               or torch.equal(getattr(a, n), getattr(b, n))
               for n in ("u", "u_full", "psf", "image", "stats"))
    if a.trajectory is None or b.trajectory is None:
        return same and a.trajectory is b.trajectory
    return same and a.trajectory.keys() == b.trajectory.keys() and all(
        np.array_equal(a.trajectory[k], b.trajectory[k]) for k in a.trajectory)


def _check_loops(label, outers, same, graph, eager, phase=11, reads=1) -> None:
    """One A/B case: ``graph`` and ``eager`` are (launches, wall, the log of
    solves) of the WHILE loop and the host loop.  Each WHILE solve of more
    than one outer makes ``reads`` host reads (1; ``tv_denoise`` 0), one of
    one outer none; each host solve one read per outer."""
    (gn, gwall, solves), (en, ewall, hosted) = graph, eager
    ms = lambda key: [round(e[key], 2) for e in solves if e[key] is not None]
    print(f"phase {phase}: {label}: {outers} outers in {len(solves)} solves; wall WHILE "
          f"{gwall:.3f} s, eager {ewall:.3f} s; host reads WHILE "
          f"{sum(e['reads'] for e in solves)} ({[e['reads'] for e in solves]} per solve), "
          f"eager {sum(e['reads'] for e in hosted)}; capture ms per solve {ms('capture_ms')}, "
          f"build + instantiation ms {ms('instantiate_ms')}; launches WHILE {json.dumps(gn)}, eager "
          f"{json.dumps(en)}")
    _require(same, f"phase {phase} {label}: WHILE and eager loops bitwise equal")
    _require(len(solves) > 0 and all(e["route"] == "while"
                                     and e["reads"] == (reads if e["outers"] > 1 else 0)
                                     for e in solves)
             and sum(e["outers"] for e in solves) == outers,
             f"phase {phase} {label}: every solve one WHILE launch, {reads} host read per solve")
    _require(len(hosted) == len(solves) and all(e["route"] == "host" and e["reads"] == e["outers"]
                                                for e in hosted)
             and sum(e["outers"] for e in hosted) == outers,
             f"phase {phase} {label}: every eager solve in the host loop, one read per outer")
    _require(all(e["k7w"] == (e["outers"] if e["outers"] > 1 else 0) for e in solves),
             f"phase {phase} {label}: K7w's own count on the card, once per outer of each "
             f"WHILE launch ({[e['k7w'] for e in solves]})")
    _require(gn["K7"] == gn["K7w"] == en["K7"] == outers and en["K7w"] == 0
             and {k: v for k, v in gn.items() if k != "K7w"}
             == {k: v for k, v in en.items() if k != "K7w"},
             f"phase {phase} {label}: the same launches in both loops, K7 once per outer in "
             "both, K7w in the WHILE loop only")


def _ab_solve(torch, dev, label, pic, mk, phase=11, **kw) -> None:
    """``_rl`` in the WHILE loop (untimed: the kernels' and cuFFT's first
    calls at these shapes), inside ``rl_mm._eager_outer_loop()``, then in
    the WHILE loop again; the three bitwise equal."""
    from ics_tpu_torch.models import rl_mm

    runs = []
    for eager in (False, True, False):
        rl_mm.loop_log.clear()
        with rl_mm._eager_outer_loop() if eager else contextlib.nullcontext():
            res, counts, wall = _rl(torch, dev, pic, mk, **kw)
        runs.append((res, (counts, wall, list(rl_mm.loop_log))))
    (first, _), (want, eager), (got, graph) = runs
    _require(_finite(torch, got), f"phase {phase} {label}: u finite")
    _check_loops(f"{label} (converged={got.converged})", got.iterations,
                 _same_bits(torch, got, want) and _same_bits(torch, got, first), graph, eager,
                 phase)


def _ab_deblur(torch, dev, label, pic, kw, profiled: bool, phase=11) -> None:
    """``deblur_module`` in the WHILE loop, then in the host loop: the
    uint16 outputs and every level's result bitwise, walls, peak memory,
    host reads, capture and instantiation time per level; with
    ``profiled``, the host loop once more under torch.profiler: its busy
    share, and its device time over the WHILE loop's wall (phase 5
    profiles 24 MP)."""
    from torch.profiler import ProfilerActivity, profile

    from ics_tpu_torch import deblur_module
    from ics_tpu_torch.models import rl_mm

    runs = []
    # phases 4 and 5 ran these cases in the WHILE loop before: both loops
    # find the kernels, plans and allocator warm
    for eager in (False, True):
        stats = []
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)  # the first run's results stay
        _zero_counters()
        rl_mm.loop_log.clear()
        with contextlib.redirect_stdout(io.StringIO()), \
                rl_mm._eager_outer_loop() if eager else contextlib.nullcontext():
            t0 = time.perf_counter()
            out = deblur_module(pic, "smoke", None, stats_out=stats, device=dev, **kw)
            wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        runs.append((out, stats, (_counters(), wall, list(rl_mm.loop_log)), peak))
    (out, stats, graph, peak), (out_e, stats_e, eager, peak_e) = runs
    same = np.array_equal(out, out_e) and len(stats) == len(stats_e) and all(
        _same_bits(torch, a["result"], b["result"]) for a, b in zip(stats, stats_e))
    print(f"phase {phase}: {label}: peak device memory above the run's start, WHILE "
          f"{peak:.3f} GiB, eager {peak_e:.3f} GiB")
    _check_loops(label, sum(s["result"].iterations for s in stats), same, graph, eager, phase)
    del out, out_e, stats, stats_e, runs
    if profiled:
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                contextlib.redirect_stdout(io.StringIO()):  # the host loop
            t0 = time.perf_counter()
            deblur_module(pic, "smoke", None, device=dev, **kw)
            wall = time.perf_counter() - t0
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        print(f"phase {phase}: {label} eager loop profiled: wall {wall:.3f} s, device busy "
              f"{busy:.3f} s, busy share {busy / wall:.3f}; derived: that device time over the "
              f"WHILE loop's wall above {busy / graph[1]:.3f} (not a trace of the WHILE run: no "
              "WHILE launch runs under the profiler, profile_run)")


def phase_outer_loop(torch, dev, pic19, pic24) -> None:
    """Phase 11: every solve of this port's main path runs its outers after
    the first as one WHILE-graph launch with the stop decided on the card
    (K7, K7w); here each case runs again in the host loop, the captured
    body launched outer by outer (``rl_mm._eager_outer_loop()``, the loop
    every solve takes under the profiler), and must give the same bits,
    outers and launches (K7w aside), with one host read per WHILE solve.
    The counters are zeroed just before each run."""
    t_phase = time.perf_counter()
    blind = dict(blind=True, tau=0.0, iterations=200)
    _ab_solve(torch, dev, "1.9MP blind 261^2 window, K2", pic19, 7, window=WINDOW19, **blind)
    _ab_solve(torch, dev, "24MP blind 520^2 window mk 9, op loop and K3", pic24, 9,
              window=WINDOW24, **blind)
    _ab_solve(torch, dev, "24MP non-blind frame, 20 outers", pic24, 9)
    for label, mk, cfg in [("high", 9, dict(conv_precision="high")),
                           ("mixed", 7, dict(dtype="mixed")),
                           ("use_tv collab", 7, dict(use_tv=True, tv_norm="collab"))]:
        _ab_solve(torch, dev, f"1.9MP non-blind frame {label}, 20 outers", pic19, mk, **cfg)
    _ab_solve(torch, dev, "1.9MP non-blind frame, early_stop 1e-2 patience 2", pic19, 7,
              iterations=200, early_stop=1e-2, early_stop_patience=2)
    _ab_solve(torch, dev, "1.9MP blind window, record_metrics", pic19, 7, window=WINDOW19,
              record_metrics=True, **blind)
    _ab_deblur(torch, dev, "deblur_module 1.9MP", pic19, bench.KW19, profiled=True)
    _ab_deblur(torch, dev, "deblur_module 24MP exact", pic24, bench.KW24, profiled=False)
    seconds = time.perf_counter() - t_phase
    print(f"phase 11: {seconds:.1f} s")
    _require(seconds <= 60.0, "phase 11 takes at most 60 s")


# --------------------------------------------------------------- phase 12
def _ab_tv_denoise(torch, dev, pic24) -> None:
    """``tv_denoise`` (the CLI's defaults: weight 0.1, 50 iterations) on the
    24 MP frame in the WHILE loop (untimed), the host loop and the WHILE
    loop again: bitwise, K7 once per iteration in both and K7w in the
    WHILE loop, no host read there."""
    from ics_tpu_torch.models import rl_mm
    from ics_tpu_torch.models.tv_denoise import tv_denoise

    image = torch.from_numpy(pic24.astype(np.float32) / 255.0).to(dev)
    runs = []
    for eager in (False, True, False):
        rl_mm.loop_log.clear()
        torch.cuda.synchronize(dev)
        _zero_counters()
        with rl_mm._eager_outer_loop() if eager else contextlib.nullcontext():
            t0 = time.perf_counter()
            out = tv_denoise(image, weight=0.1, iterations=50, device=dev)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        runs.append((out, (_counters(), wall, list(rl_mm.loop_log))))
    (first, _), (want, eager), (got, graph) = runs
    _require(bool(torch.isfinite(got).all()) and got.shape == image.shape,
             "phase 12 tv_denoise 24MP: finite, of the frame's shape")
    _check_loops("tv_denoise 24MP, 50 iterations", 50,
                 torch.equal(got, want) and torch.equal(got, first), graph, eager, 12, reads=0)


def phase_solver_loops(torch, dev, pic19, pic24) -> None:
    """Phase 12: PAM and PD (``_solve_outers``) and ``tv_denoise`` on the
    same WHILE loop, each against the host loop as in phase 11: PAM and PD
    on the 1.9 MP case's blind mask window and its non-blind frame (20
    outers), ``deblur_module`` at 1.9 MP with each, the 24 MP PD frame at 20
    fixed outers, and ``tv_denoise`` on the 24 MP frame."""
    t_phase = time.perf_counter()
    for solver in ("pam", "pd"):
        _ab_solve(torch, dev, f"{solver} 1.9MP blind 261^2 window", pic19, 7, phase=12,
                  window=WINDOW19, blind=True, tau=0.0, iterations=200, solver=solver)
        _ab_solve(torch, dev, f"{solver} 1.9MP non-blind frame, 20 outers", pic19, 7, phase=12,
                  solver=solver)
        _ab_deblur(torch, dev, f"deblur_module 1.9MP solver={solver}", pic19,
                   {**bench.KW19, "solver": solver}, profiled=False, phase=12)
    _ab_solve(torch, dev, "pd 24MP non-blind frame, 20 outers", pic24, 9, phase=12,
              solver="pd")
    _ab_tv_denoise(torch, dev, pic24)
    seconds = time.perf_counter() - t_phase
    print(f"phase 12: {seconds:.1f} s")
    _require(seconds <= 90.0, "phase 12 takes at most 90 s")


def compare_deblur_batch(other: str) -> int:
    """``--deblur-batch-against DIR``: the wall of the CLI ``deblur-batch``
    on phase 7's burst (four 24 MP 16-bit TIFFs, one 9x9 PSF, mask 511),
    each run a process of its own started from the checkout ``DIR`` or from
    this one: one untimed run of each (the kernel build), then in turns
    DIR, this, this, DIR.  The two checkouts' TIFFs must be bitwise equal.
    Then phase 8's ``imread_sequence`` reads of the same files."""
    import tempfile

    from ics_tpu_torch.models.checkpoint import SolverCheckpoint, save_checkpoint
    from ics_tpu_torch.utils.io import imread, imsave

    roots = {"other": os.path.abspath(other), "this": os.path.dirname(os.path.abspath(__file__))}
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(4):
            imsave(os.path.join(tmp, f"burst{i}.tif"),
                   make_scene(4000, 6000, 9, seed=i)[1].astype(np.uint16) * 257)
        ckpt = os.path.join(tmp, "psf.npz")
        save_checkpoint(ckpt, SolverCheckpoint(psf=_gauss_psf(9), blur_width=9))
        walls, outs = {"other": [], "this": []}, {}
        for turn, name in enumerate(["other", "this", "other", "this", "this", "other"]):
            dest = os.path.join(tmp, f"out{turn}")
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "ics_tpu_torch.cli", "deblur-batch",
                 os.path.join(tmp, "burst*.tif"), dest, "--psf", ckpt, "--mask-size", "511"],
                cwd=roots[name], env={**os.environ, "PYTHONPATH": roots[name]},
                capture_output=True, text=True)
            wall = time.perf_counter() - t0
            _require(run.returncode == 0, f"deblur-batch from {roots[name]} exits 0: "
                     f"{run.stderr[-2000:]}")
            if turn >= 2:
                walls[name].append(wall)
            outs[name] = np.stack([imread(os.path.join(dest, f"burst{i}-deblurred.tif"))
                                   for i in range(4)])
            shutil.rmtree(dest)
        print(f"CLI deblur-batch 4x24MP, a process each, after one warm-up run of each: "
              f"{roots['other']} {walls['other']} s, {roots['this']} {walls['this']} s "
              f"(turns: other, this, this, other)")
        _require(np.array_equal(outs["other"], outs["this"]),
                 "deblur-batch TIFFs bitwise equal from both checkouts")
        del outs
        _sequence_reads(tmp)
    return 0


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def compare_loop_profiles() -> int:
    """``--outer-loop-profiles``: ``profile_run`` of the 24 MP exact, 'high',
    'mixed', 'pam' and 'pd' cases (the WHILE loop's wall, the host loop's
    profile), after one unprofiled run of each mode."""
    import torch

    from ics_tpu_torch._device import exact_f32

    exact_f32()
    dev = torch.device("cuda", 0)
    print(f"card: {_card()}, torch {torch.__version__}")
    pic24 = make_scene(4000, 6000, *bench.SCENES[(4000, 6000)])[1]
    modes = [*(dict(precision=p) for p in ("exact", "high", "mixed")),
             dict(solver="pam"), dict(solver="pd")]
    for extra in modes:
        _deblur(torch, pic24, "cuda", **{**bench.KW24, **extra})
    for extra in modes:
        profile_run(torch, pic24, bench.KW24, extra)
    torch.cuda.synchronize(dev)
    return 0


def capture_memory() -> int:
    """``--capture-memory``: three runs of ``deblur_module`` in each case
    (1.9 MP; 24 MP exact, 'pam' and 'pd'), each with its wall, capture and
    instantiation milliseconds per solve, peak allocated and reserved
    memory.  Every capture shares one pool and one stream per device
    (models/rl_mm.py::_capture_pool), so a case's third run reserves no
    more memory than its second; after the third, ``_release_capture_pool``
    must hand back memory that ``torch.cuda.empty_cache`` alone keeps."""
    import torch

    from ics_tpu_torch import deblur_module
    from ics_tpu_torch._device import exact_f32
    from ics_tpu_torch.models import rl_mm

    exact_f32()
    dev = torch.device("cuda", 0)
    print(f"card: {_card()}, torch {torch.__version__}")
    pic19 = make_scene(1367, 1394, *bench.SCENES[(1367, 1394)])[1]
    pic24 = make_scene(4000, 6000, *bench.SCENES[(4000, 6000)])[1]
    for label, pic, kw in (("1.9MP", pic19, bench.KW19), ("24MP exact", pic24, bench.KW24),
                           ("24MP pam", pic24, {**bench.KW24, "solver": "pam"}),
                           ("24MP pd", pic24, {**bench.KW24, "solver": "pd"})):
        reserved = []
        for run in range(3):
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            rl_mm.loop_log.clear()
            with contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                deblur_module(pic, "smoke", None, device=dev, **kw)
                wall = time.perf_counter() - t0
            reserved.append(torch.cuda.memory_reserved(dev) / 2**30)
            log = list(rl_mm.loop_log)
            print(f"{label} run {run + 1}: wall {wall:.3f} s, capture ms "
                  f"{[round(e['capture_ms'], 2) for e in log]}, build + instantiation ms "
                  f"{[round(e['instantiate_ms'], 2) for e in log]}, peak allocated "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB, reserved "
                  f"{reserved[-1]:.3f} GiB")
        _require(reserved[2] <= reserved[1], f"{label}: the third run reserves no more memory "
                 "than the second")
        torch.cuda.empty_cache()
        emptied = torch.cuda.memory_reserved(dev) / 2**30
        rl_mm._release_capture_pool(dev)
        released = torch.cuda.memory_reserved(dev) / 2**30
        print(f"{label}: reserved {reserved[2]:.3f} GiB, {emptied:.3f} GiB after "
              f"torch.cuda.empty_cache, {released:.3f} GiB after _release_capture_pool")
        _require(released < emptied, f"{label}: releasing the capture pool hands back memory "
                 "that empty_cache cannot")
    return 0


def profiled_while(profiled: bool, reps: int = 3) -> int:
    """``--profiled-while on|off``: the sequence before fault E (ROADMAP.md
    section 3), with every WHILE launch under torch.profiler (``on``, CPU
    and CUDA activity) or none (``off``): ``reps`` times the 24 MP exact and
    'pd' ``deblur_module`` runs, then phase 7's burst of four 24 MP frames
    through ``batched_deconvolve`` 'map', all in the WHILE loop.  Each step
    synchronizes and prints as it ends, so that a fault names the step that
    ran last; the lanes must match from rep to rep bitwise.  Solves under
    a profiler take the host loop (models/rl_mm.py::_eager_loop): here
    they are held to the WHILE loop, as before that rule."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ics_tpu_torch import deblur_module
    from ics_tpu_torch._device import exact_f32
    from ics_tpu_torch.cli import batch_inputs
    from ics_tpu_torch.models import rl_mm
    from ics_tpu_torch.parallel import batched_deconvolve

    exact_f32()
    dev = torch.device("cuda", 0)
    print(f"card: {_card()}, torch {torch.__version__}, profiled: {profiled}", flush=True)
    pic24 = make_scene(4000, 6000, *bench.SCENES[(4000, 6000)])[1]
    frames = np.stack([make_scene(4000, 6000, 9, seed=i)[1].astype(np.uint16) * 257
                       for i in range(4)])
    imgs, us, psfs, window = batch_inputs(frames, _gauss_psf(9), None, 511)
    kw = dict(tau=0.01, iterations=200, step_factor=1e-3, lambd=10000.0, blind=False)
    steps = [("24MP exact", lambda: deblur_module(pic24, "smoke", None, device=dev,
                                                  **bench.KW24)),
             ("24MP pd", lambda: deblur_module(pic24, "smoke", None, device=dev,
                                               **{**bench.KW24, "solver": "pd"})),
             ("burst 4x24MP map", lambda: batched_deconvolve(imgs, us, psfs, *window,
                                                             schedule="map", device=dev,
                                                             **kw)[0])]
    lanes = None
    rl_mm._eager_loop = lambda: rl_mm._EAGER_LOOP
    for rep in range(reps):
        for label, run in steps:
            rl_mm.loop_log.clear()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
                    if profiled else contextlib.nullcontext(), \
                    contextlib.redirect_stdout(io.StringIO()):
                out = run()
                torch.cuda.synchronize(dev)
            log = list(rl_mm.loop_log)
            _require(all(e["route"] == "while" for e in log), f"{label}: the WHILE loop")
            print(f"rep {rep + 1} {label}: {time.perf_counter() - t0:.3f} s, {len(log)} WHILE "
                  f"solves, {sum(e['outers'] for e in log)} outers", flush=True)
            if label.startswith("burst"):
                if lanes is not None:
                    _require(torch.equal(out, lanes), f"rep {rep + 1} {label}: the lanes "
                             "bitwise the first rep's")
                lanes = out
    print(f"profiled={profiled}: {reps} reps, no fault")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL torch.cuda.is_available() is False: this needs a CUDA GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--deblur-batch-against"]:
        return compare_deblur_batch(sys.argv[2])
    if sys.argv[1:2] == ["--outer-loop-profiles"]:
        return compare_loop_profiles()
    if sys.argv[1:2] == ["--capture-memory"]:
        return capture_memory()
    if sys.argv[1:2] == ["--profiled-while"]:
        return profiled_while(sys.argv[2] == "on")
    t_smoke = time.perf_counter()
    from ics_tpu_torch import _build
    from ics_tpu_torch._device import exact_f32

    exact_f32()
    dev = torch.device("cuda", 0)
    smi = _card()
    print(f"card: {smi}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, nvcc: {nvcc}, "
          f"driver {driver}")
    # the WHILE graph is built in C around torch's own capture (models/rl_mm.py)
    print("CUDA graph conditional nodes (CUDAGraph.begin_capture_to_if_node): "
          f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}")
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")
    probe_while_node(torch, dev)
    from ics_tpu_torch.runtime import _lib as runtime_lib

    t0 = time.perf_counter()
    lib = runtime_lib.load()
    print(f"native runtime (ics_tpu_torch/runtime/src, first use) build + load: "
          f"{time.perf_counter() - t0:.2f} s ({' '.join(runtime_lib.compiler() or ['no compiler'])} "
          f"{runtime_lib.build_seconds if runtime_lib.build_seconds is not None else 'cached'} s): "
          f"{lib._name if lib is not None else 'not built'}")

    torch.manual_seed(0)
    t0 = time.perf_counter()
    rows = phase_kernels(dev)
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, pic19, outs19, pic24, exact24, cases = phase_pipelines(torch, dev)
    print(f"phases 3-5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(phase_cli(pic19, outs19, pic24))
    print(f"phase 6: {time.perf_counter() - t0:.1f} s")
    import tempfile

    with tempfile.TemporaryDirectory() as burst_dir:  # phase 7's TIFFs, read again in 8
        phase_parallel(torch, dev, pic19, outs19["mm"], pic24, exact24, burst_dir)
        phase_host_and_batteries(torch, dev, pic24, burst_dir)
    launches.update(phase_conv_methods(torch, dev, pic19, pic24))
    phase_bench(torch, dev, pic19, cases)
    phase_outer_loop(torch, dev, pic19, pic24)
    phase_solver_loops(torch, dev, pic19, pic24)

    sources = {
        "K1": ("ics_tpu_torch/csrc/conv2d.cu", "ics_tpu/ops/pallas_conv.py:39"),
        "K2": ("ics_tpu_torch/csrc/inner_loop.cu", "ics_tpu/ops/pallas_solver.py:75"),
        "K3": ("ics_tpu_torch/csrc/psf_grad.cu", "ics_tpu/ops/pallas_correlate.py:38"),
        "K4s": ("ics_tpu_torch/csrc/conv_mma.cu", "ics_tpu/ops/pallas_conv_mxu.py:118"),
        "K4": ("ics_tpu_torch/csrc/conv_mma.cu", "ics_tpu/ops/pallas_conv_mxu.py:170"),
        "K4h": ("ics_tpu_torch/csrc/conv_mma.cu", "ics_tpu/ops/pallas_conv_mxu.py:170"),
        "K4d": ("ics_tpu_torch/csrc/conv_mma.cu", "ics_tpu/ops/pallas_conv_mxu.py:170"),
        "K5": ("ics_tpu_torch/csrc/tv.cu", "ics_tpu/ops/pallas_tv.py:62"),
        "K6": ("ics_tpu_torch/csrc/bilateral.cu", "ics_tpu/ops/pallas_bilateral.py:58"),
        # no TPU kernel: the stop of the solver's lax.while_loop
        "K7": ("ics_tpu_torch/csrc/outer_loop.cu", "ics_tpu/models/rl_mm.py:543"),
        # no TPU kernel: the lax.while_loop node, which K7w drives
        "K7w": ("ics_tpu_torch/csrc/graph_while.cu",
                "none: the lax.while_loop node, ics_tpu/models/rl_mm.py:627"),
        # no TPU kernel: jax.image.resize's dense weight matrices
        "resize": ("ics_tpu_torch/csrc/resize.cu",
                   "none: jax.image.resize, ics_tpu/utils/resize.py:51"),
        # no TPU kernel: XLA fuses steps 4-8 of the solver's lax.scan body
        "K8": ("ics_tpu_torch/csrc/mm_step.cu",
               "none: XLA fuses steps 4-8 of ics_tpu/models/rl_mm.py:377-531"),
    }
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
         "device_ms": rows[name]["device_ms"], "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"], "library_ms": rows[name]["library_ms"],
         "lib_ms": rows[name]["library_ms"]}
        for name, (src, rep) in sources.items()
    ]}
    print(f"smoke: {time.perf_counter() - t_smoke:.1f} s")
    print(f"card: {smi}")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"FAIL {type(exc).__name__}: {exc}", file=sys.stderr)
        sys.exit(1)
