#!/usr/bin/env python3
"""Smoke run of the ``ics_tpu_torch`` port on one NVIDIA GPU.

    python3 chip_smoke.py     # one GPU, a few minutes with the kernel build

Phases:
  1. probe: the card (nvidia-smi), torch.version.cuda, nvcc, kernel build;
  2. each hand-written kernel (K1 conv, K2 inner loop, K3 PSF gradient, K4s
     split and K4 bf16 tensor-core convs, K5 TV stencil, K6 bilateral
     filter) against its plain PyTorch twin on the card, at its path's
     shapes, with CUDA-event median times of both and of the one PyTorch
     call that computes the same function where there is one, taken in
     turns; every kernel runs twice and must be bitwise equal; K2 also
     runs at the op loop's 24 MP windows beside the op loop (informational).  Each kernel's bound
     (the least time the card could take: bytes over 3.35 TB/s or operations
     over the peak rate of their type, whichever is larger) is computed
     from the shapes;
  3. the crop-scale pipeline on CUDA against the same pipeline on the CPU
     (SSIM of the uint16 outputs), in exact, mixed, high, fast and use_tv
     under each tv_norm;
  4. the 1.9 MP reference case (bench.py's kwargs) on a synthetic scene;
  5. the 24 MP case (bench.py's kwargs) in exact f32, the main path, then
     in precision 'high', in 'mixed' and with use_tv: the launch counters
     are zeroed just before each run; K1-K3 must be > 0 after the exact
     run, K4s after 'high', K4 after 'mixed' and K5 after use_tv; then one
     more exact, high and mixed run each under torch.profiler: each kernel's
     summed device time and launches, K1, K4s and K4 split into full frames
     and blind windows;
  6. the command line (``ics_tpu_torch.cli.main``) on the card, TIFF in and
     TIFF out: ``bilateral``, ``bilateral-lab``, ``usm`` and ``tv-denoise``
     with their defaults on the 24 MP frame (K6 > 0 after each bilateral
     run, K1 > 0 after usm, counters zeroed before each), ``deblur`` on the
     1.9 MP frame (K1, K2 > 0; its TIFF bitwise equal to phase 4's array),
     and ``bilateral`` / ``bilateral-lab`` at crop scale on CUDA against
     the CPU, within one 16-bit code.

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


def _median_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _time_turns(torch, kernel, plain, lib, reps: int):
    """(kernel ms, plain ms, library ms or None), timed in turns plain, lib,
    kernel, kernel, lib, plain; each the mean of its two medians."""
    p1 = _median_ms(torch, plain, reps)
    l1 = _median_ms(torch, lib, reps) if lib else None
    k1 = _median_ms(torch, kernel, reps)
    k2 = _median_ms(torch, kernel, reps)
    l2 = _median_ms(torch, lib, reps) if lib else None
    p2 = _median_ms(torch, plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2 if lib else None


# NVIDIA H100 SXM data sheet: HBM3 rate, dense peaks without sparsity
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12}


def _bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


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
    n = np.arange(blur, dtype=np.float64) - (blur - 1) / 2.0
    k1 = np.exp(-0.5 * (n / (blur / 4.0)) ** 2)
    k1 /= k1.sum()
    blurred = convolve1d(convolve1d(sharp, k1, axis=0, mode="nearest"), k1, axis=1, mode="nearest")
    blurred += rng.normal(0.0, 0.002, blurred.shape).astype(np.float32)
    return sharp, (np.clip(blurred, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0, win: int = 7) -> float:
    """Mean SSIM over channels (Wang et al. 2004, uniform 7x7 window, the
    skimage defaults) in NumPy/SciPy."""
    from scipy.ndimage import uniform_filter

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    cov = win * win / (win * win - 1)
    pad = win // 2
    vals = []
    for c in range(a.shape[-1]):
        x, y = a[..., c], b[..., c]
        ux, uy = uniform_filter(x, win), uniform_filter(y, win)
        vx = cov * (uniform_filter(x * x, win) - ux * ux)
        vy = cov * (uniform_filter(y * y, win) - uy * uy)
        vxy = cov * (uniform_filter(x * y, win) - ux * uy)
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
        vals.append(float(np.mean(s[pad:-pad, pad:-pad])))
    return float(np.mean(vals))


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
        got = cuda_conv.conv_planar(a, k, mode)
        again = cuda_conv.conv_planar(a, k, mode)
        ref = cuda_conv.conv_planar_plain(a, k, mode)
        err, rel = _rel(torch, got, ref)
        k1_err = max(k1_err, err)
        first = label == "24MP 9x9 valid"
        ms, plain, lib = _time_turns(
            torch, lambda: cuda_conv.conv_planar(a, k, mode),
            lambda: cuda_conv.conv_planar_plain(a, k, mode),
            lib_conv(a, k) if first else None, reps,
        )
        print(f"K1 {label}: max_abs_err {err:.3e} rel {rel:.3e}; "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms"
              + (f", library conv2d {lib:.4f} ms" if first else ""))
        _require(rel <= REL_TOL, f"K1 {label} within {REL_TOL:g} of its twin")
        _require(torch.equal(got, again), f"K1 {label} bitwise reproducible")
        if first:
            _lib_agrees(torch, f"K1 {label}", lib_conv(a, k)()[0], ref)
            rows["K1"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
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
            u1, p1, e1 = cuda_solver.inner_loop_planar(u0.clone(), img, psf, **kw)
            u2, p2, e2 = cuda_solver.inner_loop_planar(u0.clone(), img, psf, **kw)
            ur, pr, er = cuda_solver.inner_loop_plain(u0.clone(), img, psf, **kw)
            eu, ru = _rel(torch, u1, ur)
            ep, rp = _rel(torch, p1, pr)
            ee = float(torch.max(torch.abs(e1 - er)))
            re = ee / float(torch.max(torch.abs(img)))
            k2_err = max(k2_err, eu, ep)
            tag = f"{m + mk - 1}^2 mk {mk} blind={blind} corr={corr}"
            print(f"K2 {tag}: u {eu:.3e} (rel {ru:.3e}), psf {ep:.3e} "
                  f"(rel {rp:.3e}), err {ee:.3e} (rel to image {re:.3e})")
            _require(max(ru, rp, re) <= REL_TOL, f"K2 {tag} within {REL_TOL:g} of its twin")
            _require(
                torch.equal(u1, u2) and torch.equal(p1, p2) and torch.equal(e1, e2),
                f"K2 {tag} bitwise reproducible",
            )
            if (m, blind, corr) == (256, True, False):
                uk = u0.clone()
                ms, plain, _ = _time_turns(
                    torch, lambda: cuda_solver.inner_loop_planar(uk, img, psf, **kw),
                    lambda: cuda_solver.inner_loop_plain(u0, img, psf, **kw), None, 20,
                )
                print(f"K2 {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms per outer")
                # five blind inner steps: four convolutions each (residual,
                # correlation, fresh residual, PSF-gradient dots) and about
                # 10 operations per image pixel and 9 per window pixel;
                # u, image and psf read once, u, psf and the error written
                c, um, un = u0.shape
                n_img, n_u = c * m * m, c * um * un
                ops = 5 * (4 * 2 * mk * mk * n_img + 10 * n_img + 9 * n_u)
                nbytes = 4 * (2 * n_u + 2 * n_img + 2 * c * mk * mk)
                rows["K2"] = dict(ms=ms, plain_ms=plain, library_ms=None,
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
        ms, ops_ms, _ = _time_turns(
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
        got = cuda_correlate.psf_gradient_planar(u, err_t)
        again = cuda_correlate.psf_gradient_planar(u, err_t)
        ref = cuda_correlate.psf_gradient_plain(u, err_t)
        err, rel = _rel(torch, got, ref)
        k3_err = max(k3_err, err)
        # the library call: one grouped convolution with the error window as
        # the weight (a cross-correlation), then the flip
        lib_fn = lambda: torch.flip(
            F.conv2d(u[None], err_t[:, None], groups=3)[0], (1, 2))
        ms, plain, lib = _time_turns(
            torch, lambda: cuda_correlate.psf_gradient_planar(u, err_t),
            lambda: cuda_correlate.psf_gradient_plain(u, err_t),
            lib_fn if mk == 9 else None, 20,
        )
        tag = f"{m + mk - 1}^2 mk {mk}"
        print(f"K3 {tag}: max_abs_err {err:.3e} rel {rel:.3e}; "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms"
              + (f", library conv2d {lib:.4f} ms" if mk == 9 else ""))
        _require(rel <= REL_TOL, f"K3 {tag} within {REL_TOL:g} of its twin")
        _require(torch.equal(got, again), f"K3 {tag} bitwise reproducible")
        if mk == 9:
            _lib_agrees(torch, f"K3 {tag}", lib_fn(), ref)
            nbytes = 4 * (u.numel() + err_t.numel() + 3 * mk * mk)
            rows["K3"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              **_bound(nbytes, 2 * mk * mk * err_t.numel(), "f32"))
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
            got, again, ref = kern(a, k, mode), kern(a, k, mode), plain(a, k, mode)
            err, rel = _rel(torch, got, ref)
            first = label == "24MP 9x9 valid"
            ms, plain_ms, lib = _time_turns(torch, lambda: kern(a, k, mode),
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
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                  + (f", library conv2d {lib:.4f} ms" if first else ""))
            _require(ok, f"{name} {label} {bound}")
            _require(torch.equal(got, again), f"{name} {label} bitwise reproducible")
            worst = max(worst, err)
            if first:
                # K4s: three bf16 products of the f32 operands' halves
                # (the function is the f32 conv); K4: one, on bf16 operands
                itemsize, products = (4, 3) if name == "K4s" else (2, 1)
                rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
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
        got = cuda_tv.tv_planar(x, 1e-6, order, norm)
        again = cuda_tv.tv_planar(x, 1e-6, order, norm)
        ref = cuda_tv.tv_planar_plain(x, 1e-6, order, norm)
        errs = [_rel(torch, g, r) for g, r in zip(got, ref)]
        err, rel = max(e for e, _ in errs), max(r for _, r in errs)
        ms, plain_ms, _ = _time_turns(torch, lambda: cuda_tv.tv_planar(x, 1e-6, order, norm),
                                      lambda: cuda_tv.tv_planar_plain(x, 1e-6, order, norm),
                                      None, 5)
        tag = f"24MP order {order} L{norm} {str(dtype).split('.')[-1]}"
        bitwise = all(torch.equal(g, r) for g, r in zip(got, ref))
        print(f"K5 {tag}: max_abs_err {err:.3e} rel {rel:.3e} (bitwise equal to twin: "
              f"{bitwise}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        _require(rel <= REL_TOL, f"K5 {tag} within {REL_TOL:g} of its twin")
        _require(all(torch.equal(g, h) for g, h in zip(got, again)),
                 f"K5 {tag} bitwise reproducible")
        worst = max(worst, err)
        if (order, norm, dtype) == (2, 2, torch.float32):
            # order 2, L2: about 31 operations per interior pixel; one read,
            # two writes
            rows["K5"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
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
        got = cuda_bilateral.bilateral_planar(x, *args)
        again = cuda_bilateral.bilateral_planar(x, *args)
        ref = cuda_bilateral.bilateral_planar_plain(x, *args)
        err, rel = _rel(torch, got, ref)
        line = f"K6 {label}: max_abs_err {err:.3e} rel {rel:.3e}"
        if reps:
            ms, plain_ms, _ = _time_turns(
                torch, lambda: cuda_bilateral.bilateral_planar(x, *args),
                lambda: cuda_bilateral.bilateral_planar_plain(x, *args), None, reps,
            )
            line += f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            # per pixel and offset: difference, square, scale, exp, two
            # products, multiply-add (2) and add; one division per pixel
            offsets = (2 * radius + 1) ** 2
            rows["K6"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                              **_bound(8 * x.numel(), (9 * offsets + 1) * x.numel(), "f32"))
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


def phase_pipelines(torch, dev) -> dict:
    # 3. crop scale, CUDA vs CPU, in every mode this port runs
    crops = {5: make_scene(257, 263, 5, seed=3)[1], 9: make_scene(257, 263, 9, seed=9)[1]}
    for label, blur, extra, bound in [
        ("exact", 5, {}, 0.999),
        ("mixed", 5, dict(precision="mixed"), 0.999),
        ("high", 9, dict(precision="high"), 0.999),
        ("fast", 5, dict(precision="fast"), 0.999),
        ("use_tv collab", 5, dict(use_tv=True, tv_norm="collab"), 0.999),
        ("use_tv channel", 5, dict(use_tv=True, tv_norm="channel"), 0.999),
        ("use_tv collab_l2", 5, dict(use_tv=True, tv_norm="collab_l2"), 0.999),
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
    print(f"1.9MP SSIM vs sharp: blurred {ssim(pic19 / 255.0, sharp19):.4f}, "
          f"deblurred {ssim(out19 / 65535.0, sharp19):.4f} (informational)")

    # 5. the 24 MP case (bench.py:336-348): the main path in exact f32, then
    # the paths of K4s, K4 and K5; the counters are zeroed just before each
    # run and read just after it
    _, pic24 = make_scene(4000, 6000, 9, seed=24)
    kw24 = dict(blur_width=9, mask=[2000, 3000], mask_size=511, display=False,
                tolerance=0.1, quality="normal", preview=False, blur="static",
                iterations=200, verbose=False)
    launches = {}
    for label, extra, names in [
        ("exact", dict(precision="exact"), ("K1", "K2", "K3")),
        ("high", dict(precision="high"), ("K4s",)),
        ("mixed", dict(precision="mixed"), ("K4",)),
        ("use_tv collab", dict(precision="exact", use_tv=True, tv_norm="collab"), ("K5",)),
    ]:
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counters()
        _, wall, comp, levels = _deblur(torch, pic24, "cuda", **kw24, **extra)
        counts = _counters()
        _report(f"24MP 4000x6000 {label}", wall, comp, levels)
        print(f"24MP {label} peak device memory: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
        print(f"24MP {label} launches: {json.dumps(counts)}")
        _require(all(counts[n] > 0 for n in names),
                 f"{', '.join(names)} launched on the 24 MP {label} path")
        launches.update({n: counts[n] for n in names})
    for precision in ("exact", "high", "mixed"):
        profile_run(torch, pic24, kw24, precision)
    return launches, pic19, out19, pic24


_KERNEL_NAMES = [("conv2d_kernel", "K1"), ("inner_loop_kernel", "K2"), ("psf_grad", "K3"),
                 ("conv_mma_kernel<true", "K4s"), ("conv_mma_kernel<false", "K4"),
                 ("tv_kernel", "K5"), ("bilateral_kernel", "K6")]


# the wrappers whose launches are split by shape class in the profile
_BY_SHAPE = {"K1": ("cuda_conv", "conv_planar"), "K4s": ("cuda_conv_mma", "conv_split"),
             "K4": ("cuda_conv_mma", "conv_bf16")}


def profile_run(torch, pic24, kw24, precision: str) -> None:
    """One more 24 MP run in ``precision`` under torch.profiler: each
    kernel's summed device time and launches, K1, K4s and K4 split by shape
    class (a full frame, or a blind window of at most 600x600: the op
    loop's 369^2 and 520^2 levels)."""
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _deblur(torch, pic24, "cuda", **kw24, precision=precision)
            wall = time.perf_counter() - t0
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
             f"profiler {precision}: one K1/K4s/K4 kernel per wrapper launch")
    print(f"profile 24MP {precision}: wall {wall:.3f} s (profiled), device busy {busy:.3f} s, "
          f"busy share {busy / wall:.3f}")
    report = {k: {"launches": n, "device_s": t / 1e6} for k, (n, t) in sorted(sums.items())}
    print(f"profile 24MP {precision} kernels: " + json.dumps(report))
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


def phase_cli(pic19, out19, pic24) -> dict:
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

        # deblur on the 1.9 MP scene, as an 8-bit TIFF, with phase 4's flags
        src = os.path.join(tmp, "scene19.tif")
        imsave(src, pic19)
        wall, counts = _cli(["deblur", src, out_dir, "--blur-width", "7", "--mask", "584",
                             "795", "--tolerance", "0.1"])
        got = imread(os.path.join(out_dir, "scene19-deblurred.tif"))
        print(f"CLI deblur 1.9MP 1367x1394: wall {wall:.3f} s, launches {json.dumps(counts)}")
        _require(counts["K1"] > 0 and counts["K2"] > 0, "K1, K2 launched by the CLI deblur")
        _require(got.dtype == np.uint16 and np.array_equal(got, out19),
                 "CLI deblur TIFF bitwise equal to phase 4's array")

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL torch.cuda.is_available() is False: this needs a CUDA GPU",
              file=sys.stderr)
        return 2
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
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, nvcc: {nvcc}")
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    rows = phase_kernels(torch, dev, rng)
    launches, pic19, out19, pic24 = phase_pipelines(torch, dev)
    launches.update(phase_cli(pic19, out19, pic24))

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
         "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"], "library_ms": rows[name]["library_ms"],
         "lib_ms": rows[name]["library_ms"]}
        for name, (src, rep) in sources.items()
    ]}
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
