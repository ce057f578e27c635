#!/usr/bin/env python3
"""Smoke run of the ``ics_tpu_torch`` port on one NVIDIA GPU.

    python3 chip_smoke.py     # one GPU, a few minutes with the kernel build

Phases:
  1. probe: the card and its driver (nvidia-smi), torch.version.cuda, nvcc,
     kernel build;
  2. each hand-written kernel (K1 conv, K2 inner loop, K3 PSF gradient, K4s
     split and K4 bf16 tensor-core convs, K5 TV stencil, K6 bilateral
     filter) against its plain PyTorch twin on the card, at its path's
     shapes, with CUDA-event median times of both and of the one PyTorch
     call that computes the same function where there is one, taken in
     turns (the kernel's also as device time alone, ``device_ms``); every
     kernel runs twice, the card synchronized after each call so that a
     fault names its kernel, and must be bitwise equal; K2 also
     runs at the op loop's 24 MP windows beside the op loop (informational).  Each kernel's bound
     (the least time the card could take: bytes over 3.35 TB/s or operations
     over the peak rate of their type, whichever is larger) is computed
     from the shapes (K6's also counts the exponentials the function needs
     at the SFU's rate);
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
     K1-K3 must be > 0 after the exact run, K4s after 'high', K4 after
     'mixed', K5 after use_tv, K1, K3 and K5 after 'pam' and K3 after 'pd';
     then SSIM of the 24 MP scene as CUDA tensors (the metrics' device
     path in bands, K1) against its float64 host path; then one more
     exact, 'high', 'mixed', 'pam' and 'pd' run each under torch.profiler:
     each kernel's summed device time and launches, K1, K4s and K4 split
     into full frames and blind windows (one profiled kernel per wrapper
     launch), one psf_grad kernel per K3 call, the device time per outer
     and cuFFT's share of the device time; then the time of one rfft2 +
     irfft2 pair on PD's prime-length frame against a smooth one;
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
     for its device time per outer per lane and peak memory; (b) the CLI
     ``deblur-batch`` on those frames as 16-bit TIFFs, alone and with
     ``--shard 1`` (one NCCL rank), bitwise equal to each other and to
     (a)'s 'map' run; (c) the 24 MP ``deblur_module(mesh=...)`` on two
     gloo ranks sharing cuda:0 (their arrays and blind PSFs bitwise equal,
     SSIM >= 0.999 against phase 5); (d) ``sharded_richardson_lucy`` at the
     24 MP final level's shape, 10 outers, against one device (u 5e-5,
     stats 1e-6) and bitwise reproducible, then with a mask window in the
     second rank's rows only; (e) ``deblur --shard 1`` at 1.9
     MP, SSIM >= 0.999 against phase 4.

SSIM comes from ``ics_tpu_torch.utils.metrics``; every pass/fail comparison
computes it on the CPU, so the yardstick is independent of the kernels.
Any failure exits non-zero before the last line, which is one JSON object
``{"ok": true, "device": {...}}``; the line before it holds the kernels'
numbers as JSON.  Imports neither JAX nor ``ics_tpu``; needs a CUDA GPU.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np


class SmokeFailure(Exception):
    pass


def _require(cond: bool, what: str) -> None:
    print(("PASS " if cond else "FAIL ") + what, flush=True)
    if not cond:
        raise SmokeFailure(what)


def _median_ms(torch, fn, reps: int, device_only: bool = False) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up,
    the GPU idle at each start event: a call shorter than its wrapper's host
    time reads that host time.  With ``device_only``, a 0.1 ms sleep kernel
    ahead of each start event keeps the GPU busy while the host enqueues the
    call, so the time is the call's device time alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(200_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _time_turns(torch, kernel, plain, lib, reps: int):
    """(kernel ms, plain ms, library ms or None, kernel device ms), timed in
    turns plain, lib, kernel, kernel device, kernel device, kernel, lib,
    plain; each the mean of its two medians."""
    p1 = _median_ms(torch, plain, reps)
    l1 = _median_ms(torch, lib, reps) if lib else None
    k1 = _median_ms(torch, kernel, reps)
    d1 = _median_ms(torch, kernel, reps, device_only=True)
    d2 = _median_ms(torch, kernel, reps, device_only=True)
    k2 = _median_ms(torch, kernel, reps)
    l2 = _median_ms(torch, lib, reps) if lib else None
    p2 = _median_ms(torch, plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2 if lib else None, (d1 + d2) / 2


# NVIDIA H100 SXM data sheet: HBM3 rate, dense peaks without sparsity
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12}
# the SFU (ex2 and the other MUFU operations): 16 per clock per SM on
# compute capability 9.0 (NVIDIA's CUDA C++ documentation, the table of
# arithmetic instruction throughput), at the clock the f32 peak implies (67e12 / (132 SMs x 128
# lanes x 2)): 132 x 16 x 1.98 GHz
SFU_OPS_PER_S = 67e12 / 16


def _bound(nbytes: float, ops: float, kind: str, sfu: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate, the operations over the peak rate of their type and the
    SFU operations over the SFU's rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / PEAK_OPS_PER_S[kind], sfu / SFU_OPS_PER_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _gauss_taps(blur: int) -> np.ndarray:
    """The scenes' 1-D Gaussian blur of width ``blur`` (sigma blur/4), summing
    to 1."""
    n = np.arange(blur, dtype=np.float64) - (blur - 1) / 2.0
    k1 = np.exp(-0.5 * (n / (blur / 4.0)) ** 2)
    return k1 / k1.sum()


def make_scene(h: int, w: int, blur: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """A structured synthetic frame (blocks, edges, gradients, texture, kept
    in [0.15, 0.9]), blurred by a Gaussian PSF of width ``blur`` plus small
    noise.  Returns (sharp float32 in [0, 1], blurred uint8).

    Never uniform noise: the epsilon-free DoF blend is chaotic on it.
    """
    from scipy.ndimage import convolve1d

    rng = np.random.default_rng(seed)
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    tint = rng.uniform(-0.1, 0.1, (1, 1, 3)).astype(np.float32)
    img = 0.35 + 0.25 * xx + 0.15 * yy + tint + np.zeros((h, w, 3), np.float32)
    for _ in range(120):  # blocks with sharp edges
        bh, bw = rng.integers(h // 40, h // 6), rng.integers(w // 40, w // 6)
        y0, x0 = rng.integers(0, h - bh), rng.integers(0, w - bw)
        img[y0 : y0 + bh, x0 : x0 + bw] += rng.uniform(-0.25, 0.25, 3).astype(np.float32)
    # texture: a stripe pattern plus blocky low-resolution noise
    stripes = 0.04 * np.sin(2 * np.pi * (xx * w / 37.0 + yy * h / 53.0))
    cells = rng.uniform(-0.05, 0.05, (h // 8 + 1, w // 8 + 1, 3)).astype(np.float32)
    img += stripes + np.kron(cells, np.ones((8, 8, 1), np.float32))[:h, :w]
    sharp = np.clip(img, 0.15, 0.9).astype(np.float32)
    k1 = _gauss_taps(blur)
    blurred = convolve1d(convolve1d(sharp, k1, axis=0, mode="nearest"), k1, axis=1, mode="nearest")
    blurred += rng.normal(0.0, 0.002, blurred.shape).astype(np.float32)
    return sharp, (np.clip(blurred, 0.0, 1.0) * 255.0).round().astype(np.uint8)


# ---------------------------------------------------------------- phase 2
REL_TOL = 1e-5  # max |kernel - twin| / max |twin|; the sum order differs


def _rel(torch, got, ref) -> tuple[float, float]:
    err = float(torch.max(torch.abs(got.float() - ref.float())))
    return err, err / max(float(torch.max(torch.abs(ref.float()))), 1e-30)


LIB_TOL = 1e-3  # the library call against the twin: cuDNN picks its own algorithm


def _lib_agrees(torch, label: str, got, ref) -> None:
    """The library call that is timed beside a kernel computes its function."""
    _, rel = _rel(torch, got, ref)
    print(f"{label}: library call rel {rel:.3e} against the twin")
    _require(rel <= LIB_TOL, f"{label}: the library call computes the same function")


def _twice(torch, label: str, fn) -> list:
    """Two calls of a kernel's wrapper, the card synchronized before the
    first and after each: CUDA reports a kernel's fault at a later call, so
    this names the kernel (or the work before it) that faulted."""
    outs = []
    for stage in ("the inputs", "the first call", "the second call"):
        try:
            if stage != "the inputs":
                outs.append(fn())
            torch.cuda.synchronize()
        except Exception as exc:
            raise SmokeFailure(f"{label}, {stage}: {type(exc).__name__}: {exc}") from exc
    return outs


def _ulps(torch, got, ref) -> float:
    """Largest |got - ref| in bf16 ulps of each (positive) ref value."""
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref)) - 7)
    return float(torch.max(torch.abs(got.float() - ref) / ulp))


def phase_kernels(torch, dev, rng) -> dict:
    from ics_tpu_torch.ops import (cuda_bilateral, cuda_conv, cuda_conv_mma, cuda_correlate,
                                   cuda_solver, cuda_tv)

    rows = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def window(m, mk):
        img = rng.uniform(0.2, 0.8, (3, m // 8 + 1, m // 8 + 1))
        img = np.kron(img, np.ones((1, 8, 8)))[:, :m, :m]
        pad = mk // 2
        u = np.pad(img, ((0, 0), (pad, pad), (pad, pad)), mode="edge")
        psf = rng.uniform(0.5, 1.0, (3, mk, mk))
        return t(img), t(u), t(psf / psf.sum(axis=(1, 2), keepdims=True))

    F = torch.nn.functional

    def lib_conv(a, k):
        """One grouped cuDNN convolution of the same function, valid mode
        (TF32 is off: exact_f32 in main)."""
        return lambda: F.conv2d(a[None], torch.flip(k, (1, 2))[:, None], groups=a.shape[0])

    def conv_bound(shape, mk, itemsize, kind, products=1):
        c, h, w = shape
        ho, wo = h - mk + 1, w - mk + 1
        nbytes = itemsize * (c * h * w + c * mk * mk + c * ho * wo)
        return _bound(nbytes, products * 2 * mk * mk * c * ho * wo, kind)

    # K1 at the 24 MP non-blind shapes and the 0.707 blind window
    k1_err = 0.0
    for label, shape, mk, mode, reps in [
        ("24MP 9x9 valid", (3, 4012, 6012), 9, "valid", 5),
        ("24MP 9x9 full", (3, 4004, 6004), 9, "full", 5),
        ("369^2 7x7 valid", (3, 369, 369), 7, "valid", 20),
        ("363^2 7x7 full", (3, 363, 363), 7, "full", 20),
    ]:
        a = torch.rand(shape, dtype=torch.float32, device=dev) * 0.75 + 0.15
        k = t(rng.uniform(0.0, 1.0, (3, mk, mk)))
        got, again = _twice(torch, f"K1 {label}", lambda: cuda_conv.conv_planar(a, k, mode))
        ref = cuda_conv.conv_planar_plain(a, k, mode)
        err, rel = _rel(torch, got, ref)
        k1_err = max(k1_err, err)
        first = label == "24MP 9x9 valid"
        ms, plain, lib, dev_ms = _time_turns(
            torch, lambda: cuda_conv.conv_planar(a, k, mode),
            lambda: cuda_conv.conv_planar_plain(a, k, mode),
            lib_conv(a, k) if first else None, reps,
        )
        print(f"K1 {label}: max_abs_err {err:.3e} rel {rel:.3e}; "
              f"kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain:.4f} ms"
              + (f", library conv2d {lib:.4f} ms" if first else ""))
        _require(rel <= REL_TOL, f"K1 {label} within {REL_TOL:g} of its twin")
        _require(torch.equal(got, again), f"K1 {label} bitwise reproducible")
        if first:
            _lib_agrees(torch, f"K1 {label}", lib_conv(a, k)()[0], ref)
            rows["K1"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
                              **conv_bound(shape, mk, 4, "f32"))
        del a, got, again, ref
    rows["K1"]["max_abs_err"] = k1_err

    # K2 at the 1.9 MP finest blind window (262^2, mk 7) and the 24 MP
    # 0.5 window (261^2, mk 5)
    k2_err = 0.0
    for m, mk in [(256, 7), (257, 5)]:
        img, u0, psf = window(m, mk)
        for blind, corr in [(False, False), (True, False), (True, True)]:
            kw = dict(step_factor=1e-3, lambd=1e4, blind=blind, correlation=corr)
            tag = f"{m + mk - 1}^2 mk {mk} blind={blind} corr={corr}"
            (u1, p1, e1), (u2, p2, e2) = _twice(
                torch, f"K2 {tag}",
                lambda: cuda_solver.inner_loop_planar(u0.clone(), img, psf, **kw))
            ur, pr, er = cuda_solver.inner_loop_plain(u0.clone(), img, psf, **kw)
            eu, ru = _rel(torch, u1, ur)
            ep, rp = _rel(torch, p1, pr)
            ee = float(torch.max(torch.abs(e1 - er)))
            re = ee / float(torch.max(torch.abs(img)))
            k2_err = max(k2_err, eu, ep)
            print(f"K2 {tag}: u {eu:.3e} (rel {ru:.3e}), psf {ep:.3e} "
                  f"(rel {rp:.3e}), err {ee:.3e} (rel to image {re:.3e})")
            _require(max(ru, rp, re) <= REL_TOL, f"K2 {tag} within {REL_TOL:g} of its twin")
            _require(
                torch.equal(u1, u2) and torch.equal(p1, p2) and torch.equal(e1, e2),
                f"K2 {tag} bitwise reproducible",
            )
            if (m, blind, corr) == (256, True, False):
                uk = u0.clone()
                ms, plain, _, dev_ms = _time_turns(
                    torch, lambda: cuda_solver.inner_loop_planar(uk, img, psf, **kw),
                    lambda: cuda_solver.inner_loop_plain(u0, img, psf, **kw), None, 20,
                )
                print(f"K2 {tag}: kernel {ms:.4f} ms (device {dev_ms:.4f}), "
                      f"plain {plain:.4f} ms per outer")
                # five blind inner steps: four convolutions each (residual,
                # correlation, fresh residual, PSF-gradient dots) and about
                # 10 operations per image pixel and 9 per window pixel;
                # u, image and psf read once, u, psf and the error written
                c, um, un = u0.shape
                n_img, n_u = c * m * m, c * um * un
                ops = 5 * (4 * 2 * mk * mk * n_img + 10 * n_img + 9 * n_u)
                nbytes = 4 * (2 * n_u + 2 * n_img + 2 * c * mk * mk)
                rows["K2"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=None,
                                  **_bound(nbytes, ops, "f32"))
    rows["K2"]["max_abs_err"] = k2_err

    # K2 called directly at the 24 MP op-loop windows (369^2 mk 7, 520^2 mk
    # 9), beside the op loop's time per outer there (K1 and K3 with torch
    # elementwise passes): informational, the solver keeps the JAX bound
    from functools import partial

    from ics_tpu_torch.ops.conv import conv_planar

    for m, mk in [(363, 7), (512, 9)]:
        img, u0, psf = window(m, mk)
        kw = dict(step_factor=1e-3, lambd=1e4, blind=True, correlation=False)
        u1, p1, _ = cuda_solver.inner_loop_planar(u0.clone(), img, psf, **kw)
        ur, pr, _ = cuda_solver.inner_loop_plain(u0.clone(), img, psf, **kw)
        uk = u0.clone()
        ops_kw = dict(conv=partial(conv_planar, precision="exact"),
                      psf_grad=cuda_correlate.psf_gradient_planar, **kw)
        ms, ops_ms, _, _ = _time_turns(
            torch, lambda: cuda_solver.inner_loop_planar(uk, img, psf, **kw),
            lambda: cuda_solver.inner_loop_ops(u0, img, psf, **ops_kw), None, 10,
        )
        print(f"K2 direct {m + mk - 1}^2 mk {mk} blind (informational, outside the JAX "
              f"window bound): kernel {ms:.4f} ms per outer, op loop {ops_ms:.4f} ms per "
              f"outer; u rel {_rel(torch, u1, ur)[1]:.3e}, psf rel {_rel(torch, p1, pr)[1]:.3e}")

    # K3 at the 24 MP 0.707 and 1.0 blind windows
    k3_err = 0.0
    for m, mk in [(363, 7), (512, 9)]:
        img, u, psf = window(m, mk)
        err_t = cuda_conv.conv_planar_plain(u, psf, "valid") - img
        tag = f"{m + mk - 1}^2 mk {mk}"
        got, again = _twice(torch, f"K3 {tag}",
                            lambda: cuda_correlate.psf_gradient_planar(u, err_t))
        ref = cuda_correlate.psf_gradient_plain(u, err_t)
        err, rel = _rel(torch, got, ref)
        k3_err = max(k3_err, err)
        # the library call: one grouped convolution with the error window as
        # the weight (a cross-correlation), then the flip
        lib_fn = lambda: torch.flip(
            F.conv2d(u[None], err_t[:, None], groups=3)[0], (1, 2))
        ms, plain, lib, dev_ms = _time_turns(
            torch, lambda: cuda_correlate.psf_gradient_planar(u, err_t),
            lambda: cuda_correlate.psf_gradient_plain(u, err_t),
            lib_fn if mk == 9 else None, 20,
        )
        nbytes = 4 * (u.numel() + err_t.numel() + 3 * mk * mk)
        bound = _bound(nbytes, 2 * mk * mk * err_t.numel(), "f32")
        print(f"K3 {tag}: max_abs_err {err:.3e} rel {rel:.3e}; "
              f"kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})"
              + (f", library conv2d {lib:.4f} ms" if mk == 9 else ""))
        _require(rel <= REL_TOL, f"K3 {tag} within {REL_TOL:g} of its twin")
        _require(torch.equal(got, again), f"K3 {tag} bitwise reproducible")
        if mk == 9:
            _lib_agrees(torch, f"K3 {tag}", lib_fn(), ref)
            rows["K3"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
                              **bound)
    rows["K3"]["max_abs_err"] = k3_err

    # K4s and K4 at the 24 MP non-blind shapes, the 520^2 op-loop window
    # (what K4s takes under 'high'), the 369^2 7x7 window and a plane of odd
    # width (a pyramid level's size; K4 stages it with plain loads)
    for name in ("K4s", "K4"):
        worst = 0.0
        for label, shape, mk, mode, reps in [
            ("24MP 9x9 valid", (3, 4012, 6012), 9, "valid", 5),
            ("24MP 9x9 full", (3, 4004, 6004), 9, "full", 5),
            ("520^2 9x9 valid", (3, 520, 520), 9, "valid", 20),
            ("369^2 7x7 valid", (3, 369, 369), 7, "valid", 20),
            ("odd width 2837x4251 9x9 full", (3, 2837, 4251), 9, "full", 5),
        ]:
            a = torch.rand(shape, dtype=torch.float32, device=dev) * 0.75 + 0.15
            k = t(rng.uniform(0.05, 1.0, (3, mk, mk)))
            if name == "K4s":
                kern, plain = cuda_conv_mma.conv_split, cuda_conv_mma.conv_split_plain
            else:
                a, k = a.bfloat16(), k.bfloat16()
                kern, plain = cuda_conv_mma.conv_bf16, cuda_conv_mma.conv_bf16_plain
            got, again = _twice(torch, f"{name} {label}", lambda: kern(a, k, mode))
            ref = plain(a, k, mode)
            err, rel = _rel(torch, got, ref)
            first = label == "24MP 9x9 valid"
            ms, plain_ms, lib, dev_ms = _time_turns(torch, lambda: kern(a, k, mode),
                                                    lambda: plain(a, k, mode),
                                                    lib_conv(a, k) if first else None, reps)
            if name == "K4s":
                bound = f"within {REL_TOL:g} of its twin"
                ok = rel <= REL_TOL
                detail = f"rel {rel:.3e}"
            else:
                ulps = _ulps(torch, got, ref)
                bound = "within one bf16 ulp of its twin"
                ok = ulps <= 1.0
                detail = f"{ulps:.2f} bf16 ulp"
            print(f"{name} {label}: max_abs_err {err:.3e} {detail}; "
                  f"kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms"
                  + (f", library conv2d {lib:.4f} ms" if first else ""))
            _require(ok, f"{name} {label} {bound}")
            _require(torch.equal(got, again), f"{name} {label} bitwise reproducible")
            worst = max(worst, err)
            if first:
                # K4s: three bf16 products of the f32 operands' halves
                # (the function is the f32 conv); K4: one, on bf16 operands
                itemsize, products = (4, 3) if name == "K4s" else (2, 1)
                rows[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib,
                                  **conv_bound(shape, mk, itemsize, "bf16", products))
            del a, got, again, ref
        rows[name]["max_abs_err"] = worst

    # K5 at the 24 MP non-blind frame, every (order, norm), and bf16 once
    worst = 0.0
    u = torch.rand((3, 4001, 6001), dtype=torch.float32, device=dev) * 0.75 + 0.15
    for order, norm, dtype in [(2, 1, torch.float32), (2, 2, torch.float32),
                               (1, 1, torch.float32), (1, 2, torch.float32),
                               (2, 2, torch.bfloat16)]:
        x = u.to(dtype)
        tag = f"24MP order {order} L{norm} {str(dtype).split('.')[-1]}"
        got, again = _twice(torch, f"K5 {tag}", lambda: cuda_tv.tv_planar(x, 1e-6, order, norm))
        ref = cuda_tv.tv_planar_plain(x, 1e-6, order, norm)
        errs = [_rel(torch, g, r) for g, r in zip(got, ref)]
        err, rel = max(e for e, _ in errs), max(r for _, r in errs)
        ms, plain_ms, _, dev_ms = _time_turns(
            torch, lambda: cuda_tv.tv_planar(x, 1e-6, order, norm),
            lambda: cuda_tv.tv_planar_plain(x, 1e-6, order, norm), None, 5)
        bitwise = all(torch.equal(g, r) for g, r in zip(got, ref))
        print(f"K5 {tag}: max_abs_err {err:.3e} rel {rel:.3e} (bitwise equal to twin: "
              f"{bitwise}); kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms")
        _require(rel <= REL_TOL, f"K5 {tag} within {REL_TOL:g} of its twin")
        _require(all(torch.equal(g, h) for g, h in zip(got, again)),
                 f"K5 {tag} bitwise reproducible")
        worst = max(worst, err)
        if (order, norm, dtype) == (2, 2, torch.float32):
            # order 2, L2: about 31 operations per interior pixel; one read,
            # two writes
            rows["K5"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
                              **_bound(4 * 3 * x.numel(), 31 * x.numel(), "f32"))
        del x, got, again, ref
    rows["K5"]["max_abs_err"] = worst
    del u

    # K6 at one 24 MP plane (the CLI's bilateral filters each channel), a
    # 3-plane crop, a 24 MP L plane on the 0-100 scale (bilateral-lab) and a
    # plane smaller than 2r+1 on a side; std_s 5.0, the CLI default
    worst = 0.0
    for label, shape, radius, std_i, scale, reps in [
        ("24MP plane r5", (1, 4000, 6000), 5, 0.1, 1.0, 3),
        ("3x257x263 r2", (3, 257, 263), 2, 0.1, 1.0, 0),
        ("24MP L plane r5 std_i 5", (1, 4000, 6000), 5, 5.0, 100.0, 0),
        ("7x4 plane r5", (1, 7, 4), 5, 0.1, 1.0, 0),
    ]:
        x = torch.rand(shape, dtype=torch.float32, device=dev) * scale
        args = (radius, std_i, 5.0)
        got, again = _twice(torch, f"K6 {label}",
                            lambda: cuda_bilateral.bilateral_planar(x, *args))
        ref = cuda_bilateral.bilateral_planar_plain(x, *args)
        err, rel = _rel(torch, got, ref)
        line = f"K6 {label}: max_abs_err {err:.3e} rel {rel:.3e}"
        if reps:
            ms, plain_ms, _, dev_ms = _time_turns(
                torch, lambda: cuda_bilateral.bilateral_planar(x, *args),
                lambda: cuda_bilateral.bilateral_planar_plain(x, *args), None, reps,
            )
            line += f"; kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms"
            # per pixel and offset: difference, square, scale, exp, two
            # products, multiply-add (2) and add; one division per pixel.
            # The exponentials the function needs go to the SFU: the
            # centre's weight is 1 and w(p, d) = w(p + d, -d), so
            # (offsets - 1) / 2 per pixel
            offsets = (2 * radius + 1) ** 2
            nbytes, ops = 8 * x.numel(), (9 * offsets + 1) * x.numel()
            exps = (offsets - 1) // 2 * x.numel()
            rows["K6"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
                              **_bound(nbytes, ops, "f32", sfu=exps))
            f32_ms = ops / PEAK_OPS_PER_S["f32"] * 1e3
            sfu_ms, one_each_ms = (e / SFU_OPS_PER_S * 1e3
                                   for e in (exps, offsets * x.numel()))
            line += (f"; bound {rows['K6']['bound_ms']:.4f} ms ({rows['K6']['bound_by']}; "
                     f"{rows['K6']['bound_ms'] / ms:.1%} of it): f32 operations "
                     f"{f32_ms:.4f} ms, SFU {sfu_ms:.4f} ms at {(offsets - 1) // 2} "
                     f"exponentials per pixel ({one_each_ms:.4f} ms at one per offset, "
                     f"as this kernel computes them)")
        print(line)
        _require(rel <= REL_TOL, f"K6 {label} within {REL_TOL:g} of its twin")
        _require(torch.equal(got, again), f"K6 {label} bitwise reproducible")
        worst = max(worst, err)
        del x, got, again, ref
    rows["K6"]["max_abs_err"] = worst
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
    """{kernel: launches so far} over every wrapper's counter."""
    from ics_tpu_torch.ops import (cuda_bilateral, cuda_conv, cuda_conv_mma, cuda_correlate,
                                   cuda_solver, cuda_tv)

    return {
        "K1": cuda_conv.launches, "K2": cuda_solver.launches,
        "K3": cuda_correlate.launches, "K4s": cuda_conv_mma.split_launches,
        "K4": cuda_conv_mma.bf16_launches, "K5": cuda_tv.launches,
        "K6": cuda_bilateral.launches,
    }


def _zero_counters() -> None:
    from ics_tpu_torch.ops import (cuda_bilateral, cuda_conv, cuda_conv_mma, cuda_correlate,
                                   cuda_solver, cuda_tv)

    for mod in (cuda_conv, cuda_solver, cuda_correlate, cuda_tv, cuda_bilateral):
        mod.launches = 0
    cuda_conv_mma.split_launches = cuda_conv_mma.bf16_launches = 0


# the 24 MP case's kwargs (bench.py:336-348)
KW24 = dict(blur_width=9, mask=[2000, 3000], mask_size=511, display=False, tolerance=0.1,
            quality="normal", preview=False, blur="static", iterations=200, verbose=False)

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
    sharp19, pic19 = make_scene(1367, 1394, 7, seed=19)
    kw19 = dict(blur_width=7, mask=[584, 795], display=False, tolerance=0.1,
                quality="normal", preview=False, blur="static", iterations=200,
                verbose=False, precision="exact")
    out19, wall, comp, levels = _deblur(torch, pic19, "cuda", **kw19)
    _report("1.9MP 1367x1394", wall, comp, levels)
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
    sharp24, pic24 = make_scene(4000, 6000, 9, seed=24)
    kw24 = KW24
    launches, solver_launches = {}, {}
    for label, extra, names in [
        ("exact", dict(precision="exact"), ("K1", "K2", "K3")),
        ("high", dict(precision="high"), ("K4s",)),
        ("mixed", dict(precision="mixed"), ("K4",)),
        ("use_tv collab", dict(precision="exact", use_tv=True, tv_norm="collab"), ("K5",)),
        *((f"solver={solver}", dict(solver=solver), names)
          for solver, names in SOLVER_KERNELS.items()),
    ]:
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counters()
        out24, wall, comp, levels = _deblur(torch, pic24, "cuda", **kw24, **extra)
        counts = _counters()
        if label == "exact":
            out24_exact, levels24_exact = out24, levels
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
    return launches, pic19, outs19, pic24, (out24_exact, levels24_exact)


def prime_fft_times(torch, dev) -> None:
    """Event time of one rfft2 + irfft2 pair on PD's 24 MP final-level frame
    (3x4003x6003; 4003 is prime) against the smooth 3x4000x6000."""
    g = torch.Generator(device=dev).manual_seed(7)
    for shape in ((3, 4003, 6003), (3, 4000, 6000)):
        x = torch.rand(shape, generator=g, device=dev)
        fft_ms = _median_ms(torch, lambda: torch.fft.irfft2(torch.fft.rfft2(x), s=shape[1:]), 5)
        print(f"cuFFT rfft2 + irfft2 f32 {'x'.join(map(str, shape))}: {fft_ms:.3f} ms")
        del x


_KERNEL_NAMES = [("conv2d_kernel", "K1"), ("inner_loop_kernel", "K2"), ("psf_grad", "K3"),
                 ("conv_mma_kernel<true", "K4s"), ("conv_mma_kernel<false", "K4"),
                 ("tv_kernel", "K5"), ("bilateral_kernel", "K6")]


# the wrappers whose launches are split by shape class in the profile
_BY_SHAPE = {"K1": ("cuda_conv", "conv_planar"), "K4s": ("cuda_conv_mma", "conv_split"),
             "K4": ("cuda_conv_mma", "conv_bf16")}


def profile_run(torch, pic24, kw24, extra: dict) -> None:
    """One more 24 MP run with ``extra`` (a precision or a solver) under
    torch.profiler: each kernel's summed device time and launches, K1, K4s
    and K4 split by shape class (a full frame, or a blind window of at most
    600x600: the op loop's 369^2 and 520^2 levels), and cuFFT's share."""
    label = " ".join(f"{v}" if k == "precision" else f"{k}={v}" for k, v in extra.items())
    from torch.profiler import ProfilerActivity, profile

    from ics_tpu_torch.ops import cuda_conv, cuda_conv_mma

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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, _, _, levels = _deblur(torch, pic24, "cuda", **kw24, **extra)
            wall = time.perf_counter() - t0
        counts = _counters()
    finally:
        for kid, (m, f) in _BY_SHAPE.items():
            setattr(mods[m], f, originals[kid])
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
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
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    _require(all(seen[k] == len(classes[k]) for k in seen),
             f"profiler {label}: one K1/K4s/K4 kernel per wrapper launch")
    k3_kernels = sums.get("K3", (0, 0.0))[0]
    print(f"profile 24MP {label}: {k3_kernels} psf_grad kernels, K3 launches {counts['K3']}")
    _require(k3_kernels == counts["K3"], f"profiler {label}: one psf_grad kernel per K3 call")
    outers = sum(n for _, _, n, _ in levels)
    print(f"profile 24MP {label}: wall {wall:.3f} s (profiled), device busy {busy:.3f} s, "
          f"busy share {busy / wall:.3f}, {outers} outers, "
          f"{busy / outers * 1e3:.3f} ms device time per outer (all levels)")
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
    k1 = _gauss_taps(blur)
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
    'map' lane against a single richardson_lucy_MM call."""
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            u_b, _, stats_b = batched_deconvolve(imgs, us, psfs, *window, schedule=schedule,
                                                 device=dev, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = _counters()
        outers = [int(n) for n in stats_b[:, 0].tolist()]
        device_s = _device_seconds(torch, prof)
        print(f"burst 4x24MP '{schedule}': wall {wall:.3f} s, per-lane outers {outers}, "
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
                            **KW24)
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


def phase_parallel(torch, dev, pic19, out19, pic24, exact24) -> None:
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
            imsave(os.path.join(tmp, f"burst{i}.tif"), frame)
        del frames
        ckpt = os.path.join(tmp, "psf.npz")
        save_checkpoint(ckpt, SolverCheckpoint(psf=psf, blur_width=9))
        outs = {}
        for extra in ([], ["--shard", "1"]):
            dest = os.path.join(tmp, f"batch{len(extra)}")
            wall, counts = _cli(["deblur-batch", os.path.join(tmp, "burst*.tif"), dest, "--psf",
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL torch.cuda.is_available() is False: this needs a CUDA GPU",
              file=sys.stderr)
        return 2
    t_smoke = time.perf_counter()
    from ics_tpu_torch import _build
    from ics_tpu_torch._device import exact_f32

    exact_f32()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, nvcc: {nvcc}, "
          f"driver {driver}")
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    rows = phase_kernels(torch, dev, rng)
    launches, pic19, outs19, pic24, exact24 = phase_pipelines(torch, dev)
    launches.update(phase_cli(pic19, outs19, pic24))
    phase_parallel(torch, dev, pic19, outs19["mm"], pic24, exact24)

    sources = {
        "K1": ("ics_tpu_torch/csrc/conv2d.cu", "ics_tpu/ops/pallas_conv.py:39"),
        "K2": ("ics_tpu_torch/csrc/inner_loop.cu", "ics_tpu/ops/pallas_solver.py:75"),
        "K3": ("ics_tpu_torch/csrc/psf_grad.cu", "ics_tpu/ops/pallas_correlate.py:38"),
        "K4s": ("ics_tpu_torch/csrc/conv_mma.cu", "ics_tpu/ops/pallas_conv_mxu.py:118"),
        "K4": ("ics_tpu_torch/csrc/conv_mma.cu", "ics_tpu/ops/pallas_conv_mxu.py:170"),
        "K5": ("ics_tpu_torch/csrc/tv.cu", "ics_tpu/ops/pallas_tv.py:62"),
        "K6": ("ics_tpu_torch/csrc/bilateral.cu", "ics_tpu/ops/pallas_bilateral.py:58"),
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
