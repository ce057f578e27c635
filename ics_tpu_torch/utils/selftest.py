"""On-card certification and microbenchmarks of the port's CUDA kernels, and
the blind-restoration batteries (counterpart of ics_tpu/utils/selftest.py).

``certify_kernels`` holds every hand-written kernel (K1-K8, K7w, the resize) against
its plain PyTorch twin on the GPU at the shapes of the 24 MP path, then the K2
inner loop against the op loop on one blind solve, then the pipeline's
pre- and postprocess and cubic resize against the same steps done one
torch op at a time.  A CUDA kernel cannot run on the CPU, so it raises
there.  ``chip_smoke.py`` runs it as its phase 2 and takes the kernels
line from its rows.

``bench_conv_backends`` times the 'same'-mode 9x9 per-channel conv of
each ``convolve_rgb`` method and dtype, with JAX's arguments and keys, and
of each kernel named in ``kernels``, as a chain of calls between two CUDA
events with one sync at the end (the counterpart of the JAX file's
``lax.scan`` chain).  JAX records a method that fails as ``None``; here a
kernel that faults raises, so no fault on the card passes as data.
``bench_scaling`` times the row-sharded solve on 1, 2, 4 and 8 ranks.

The battery helpers (``make_success_battery``, ``synth_blur_case``,
``rel_error``, ``_sharp_frame``, ``_sharp_crop``, ``_blob_kernel``,
``_fitted_kernel``) are host NumPy/SciPy copied from the JAX file: they give
the same bytes, fallbacks included.  The reference implementation's images
(``original.jpg``, ``blured.jpg``, ``153412.jpg``) are read, read-only, from
the directory passed as ``reference``; without one, the deterministic
stand-ins of the JAX file's fallbacks are used.
"""

from __future__ import annotations

import os
import time

import numpy as np

__all__ = [
    "certify_kernels",
    "bench_conv_backends",
    "bench_scaling",
    "bench_success_rate",
    "bench_precision_quality",
]


def _fixture(reference, name: str) -> str | None:
    """``name`` in the reference images' directory ``reference`` when it is
    there, else None (the stand-in)."""
    if reference is None:
        return None
    path = os.path.join(os.fspath(reference), name)
    return path if os.path.exists(path) else None


def _real_image(h: int, w: int, reference=None) -> np.ndarray:
    """An (h, w, 3) float32 frame in [0, 1]: the reference's
    ``crop-blured.jpg`` from ``reference``, tiled, else the JAX file's
    stand-in, ``default_rng(0)``'s 512^2 noise, tiled (the same bytes)."""
    path = _fixture(reference, "crop-blured.jpg")
    if path is not None:
        from PIL import Image

        with Image.open(path) as im:
            base = np.asarray(im, np.float32) / 255.0
    else:
        base = np.random.default_rng(0).random((512, 512, 3)).astype(np.float32)
    reps = (-(-h // base.shape[0]), -(-w // base.shape[1]), 1)
    return np.tile(base, reps)[:h, :w]


# ------------------------------------------------------------------ scenes
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


# ------------------------------------------------------------ card timing
def _cuda(device):
    """``device`` as a CUDA ``torch.device``; raises on the CPU or without a
    GPU: the kernels run on the card only."""
    import torch

    from ics_tpu_torch._device import exact_f32, resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"device {device!r}: the CUDA kernels run on a GPU only")
    exact_f32()
    return torch.device("cuda", dev.index if dev.index is not None else torch.cuda.current_device())


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


# ------------------------------------------------------------ certification
REL_TOL = 1e-5  # max |kernel - twin| / max |twin|; the sum order differs
LIB_TOL = 1e-3  # the library call against the twin: cuDNN picks its own algorithm
# K4h against its float64 twin: above K4h's own readings (2.0-3.5e-7 of the
# largest value on an H100) and below K4s's bf16x3 on the same twin, so a
# kernel that drops HIGHEST's extra products fails
HIGHEST_TOL = 7e-7
# the banded resize against its dense twin: the same float32 weights and an
# fmaf chain over the same non-zero terms, which cuBLAS's row pass sums in
# another order (2 ulps apart at most at values just above 1)
RESIZE_TOL = 2.5e-7


class _Fault(Exception):
    """A kernel call raised: CUDA may have lost its context, so the
    certification stops there."""


class _Checks:
    """Reports each check as ``[selftest] PASS|FAIL what`` and keeps the
    failures."""

    def __init__(self, report):
        self.report = report
        self.failed: list[str] = []
        self.count = 0

    def __call__(self, cond: bool, what: str) -> None:
        self.count += 1
        self.report(f"[selftest] {'PASS' if cond else 'FAIL'} {what}")
        if not cond:
            self.failed.append(what)


def _rel(torch, got, ref) -> tuple[float, float]:
    err = float(torch.max(torch.abs(got.float() - ref.float())))
    return err, err / max(float(torch.max(torch.abs(ref.float()))), 1e-30)


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
            raise _Fault(f"{label}, {stage}: {type(exc).__name__}: {exc}") from exc
    return outs


def _once(torch, label: str, fn) -> None:
    """One call of a kernel's wrapper, the card synchronized after it (as
    ``_twice``, for a kernel whose call changes its state)."""
    try:
        fn()
        torch.cuda.synchronize()
    except Exception as exc:
        raise _Fault(f"{label}: {type(exc).__name__}: {exc}") from exc


def _same_bits(torch, got, ref) -> bool:
    """Bitwise equal, NaN at the same places (a NaN's payload aside)."""
    nan = torch.isnan(ref)
    return got.shape == ref.shape and torch.equal(torch.isnan(got), nan) and torch.equal(
        got.masked_fill(nan, 0.0).view(torch.int32), ref.masked_fill(nan, 0.0).view(torch.int32))


def _ulps(torch, got, ref) -> float:
    """Largest |got - ref| in bf16 ulps of each (positive) ref value."""
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref)) - 7)
    return float(torch.max(torch.abs(got.float() - ref) / ulp))


class _Certify:
    """The sections of ``certify_kernels``; ``rows`` gets each kernel's
    ``max_abs_err``, its times and its bound."""

    def __init__(self, torch, dev, check, report, rows: dict):
        self.torch, self.dev, self.check, self.report = torch, dev, check, report
        self.rows = rows
        self.rng = np.random.default_rng(0)
        self.gen = torch.Generator(device=dev).manual_seed(0)
        self.F = torch.nn.functional

    def t(self, a):
        return self.torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.dev)

    def rand(self, shape, scale=0.75, offset=0.15):
        return (self.torch.rand(shape, dtype=self.torch.float32, device=self.dev,
                                generator=self.gen) * scale + offset)

    def window(self, m, mk):
        """A blocky (3, m, m) window, its edge-padded u and a PSF summing to 1
        per channel."""
        img = self.rng.uniform(0.2, 0.8, (3, m // 8 + 1, m // 8 + 1))
        img = np.kron(img, np.ones((1, 8, 8)))[:, :m, :m]
        pad = mk // 2
        u = np.pad(img, ((0, 0), (pad, pad), (pad, pad)), mode="edge")
        psf = self.rng.uniform(0.5, 1.0, (3, mk, mk))
        return self.t(img), self.t(u), self.t(psf / psf.sum(axis=(1, 2), keepdims=True))

    def lib_conv(self, a, k):
        """One grouped cuDNN convolution of the same function, valid mode
        (TF32 is off)."""
        return lambda: self.F.conv2d(a[None], self.torch.flip(k, (1, 2))[:, None],
                                     groups=a.shape[0])

    def lib_agrees(self, label: str, got, ref) -> None:
        """The library call that is timed beside a kernel computes its function."""
        _, rel = _rel(self.torch, got, ref)
        self.report(f"{label}: library call rel {rel:.3e} against the twin")
        self.check(rel <= LIB_TOL, f"{label}: the library call computes the same function")

    @staticmethod
    def conv_bound(shape, mk, itemsize, kind, products=1):
        c, h, w = shape
        ho, wo = h - mk + 1, w - mk + 1
        nbytes = itemsize * (c * h * w + c * mk * mk + c * ho * wo)
        return _bound(nbytes, products * 2 * mk * mk * c * ho * wo, kind)

    def k1(self):
        """K1 at the 24 MP non-blind shapes and the 0.707 blind window."""
        from ics_tpu_torch.ops import cuda_conv

        torch, worst = self.torch, 0.0
        for label, shape, mk, mode, reps in [
            ("24MP 9x9 valid", (3, 4012, 6012), 9, "valid", 5),
            ("24MP 9x9 full", (3, 4004, 6004), 9, "full", 5),
            ("369^2 7x7 valid", (3, 369, 369), 7, "valid", 20),
            ("363^2 7x7 full", (3, 363, 363), 7, "full", 20),
        ]:
            a = self.rand(shape)
            k = self.t(self.rng.uniform(0.0, 1.0, (3, mk, mk)))
            got, again = _twice(torch, f"K1 {label}", lambda: cuda_conv.conv_planar(a, k, mode))
            ref = cuda_conv.conv_planar_plain(a, k, mode)
            err, rel = _rel(torch, got, ref)
            worst = max(worst, err)
            line = f"K1 {label}: max_abs_err {err:.3e} rel {rel:.3e}"
            first = label == "24MP 9x9 valid"
            ms, plain, lib, dev_ms = _time_turns(
                torch, lambda: cuda_conv.conv_planar(a, k, mode),
                lambda: cuda_conv.conv_planar_plain(a, k, mode),
                self.lib_conv(a, k) if first else None, reps,
            )
            line += (f"; kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain:.4f} ms"
                     + (f", library conv2d {lib:.4f} ms" if first else ""))
            if first:
                self.rows["K1"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                                       library_ms=lib, **self.conv_bound(shape, mk, 4, "f32"))
            self.report(line)
            self.check(rel <= REL_TOL, f"K1 {label} within {REL_TOL:g} of its twin")
            self.check(torch.equal(got, again), f"K1 {label} bitwise reproducible")
            if first:
                self.lib_agrees(f"K1 {label}", self.lib_conv(a, k)()[0], ref)
            del a, got, again, ref
        self.rows.setdefault("K1", {})["max_abs_err"] = worst

    def k2(self):
        """K2 at the 1.9 MP finest blind window (262^2, mk 7) and the 24 MP
        0.5 window (261^2, mk 5); then, timed, directly at the 24 MP op-loop
        windows beside the op loop (informational: the solver keeps the JAX
        window bound)."""
        from functools import partial

        from ics_tpu_torch.ops import cuda_correlate, cuda_solver
        from ics_tpu_torch.ops.conv import conv_planar

        torch, worst = self.torch, 0.0
        for m, mk in [(256, 7), (257, 5)]:
            img, u0, psf = self.window(m, mk)
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
                worst = max(worst, eu, ep)
                self.report(f"K2 {tag}: u {eu:.3e} (rel {ru:.3e}), psf {ep:.3e} "
                            f"(rel {rp:.3e}), err {ee:.3e} (rel to image {re:.3e})")
                self.check(max(ru, rp, re) <= REL_TOL, f"K2 {tag} within {REL_TOL:g} of its twin")
                self.check(
                    torch.equal(u1, u2) and torch.equal(p1, p2) and torch.equal(e1, e2),
                    f"K2 {tag} bitwise reproducible",
                )
                if (m, blind, corr) == (256, True, False):
                    uk = u0.clone()
                    ms, plain, _, dev_ms = _time_turns(
                        torch, lambda: cuda_solver.inner_loop_planar(uk, img, psf, **kw),
                        lambda: cuda_solver.inner_loop_plain(u0, img, psf, **kw), None, 20,
                    )
                    self.report(f"K2 {tag}: kernel {ms:.4f} ms (device {dev_ms:.4f}), "
                                f"plain {plain:.4f} ms per outer")
                    # five blind inner steps: four convolutions each (residual,
                    # correlation, fresh residual, PSF-gradient dots) and about
                    # 10 operations per image pixel and 9 per window pixel;
                    # u, image and psf read once, u, psf and the error written
                    c, um, un = u0.shape
                    n_img, n_u = c * m * m, c * um * un
                    ops = 5 * (4 * 2 * mk * mk * n_img + 10 * n_img + 9 * n_u)
                    nbytes = 4 * (2 * n_u + 2 * n_img + 2 * c * mk * mk)
                    self.rows["K2"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                                           library_ms=None, **_bound(nbytes, ops, "f32"))
        self.rows.setdefault("K2", {})["max_abs_err"] = worst
        for m, mk in [(363, 7), (512, 9)]:
            img, u0, psf = self.window(m, mk)
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
            self.report(
                f"K2 direct {m + mk - 1}^2 mk {mk} blind (informational, outside the JAX "
                f"window bound): kernel {ms:.4f} ms per outer, op loop {ops_ms:.4f} ms per "
                f"outer; u rel {_rel(torch, u1, ur)[1]:.3e}, psf rel {_rel(torch, p1, pr)[1]:.3e}")

    def k3(self):
        """K3 at the 24 MP 0.707 and 1.0 blind windows."""
        from ics_tpu_torch.ops import cuda_conv, cuda_correlate

        torch, F, worst = self.torch, self.F, 0.0
        for m, mk in [(363, 7), (512, 9)]:
            img, u, psf = self.window(m, mk)
            err_t = cuda_conv.conv_planar_plain(u, psf, "valid") - img
            tag = f"{m + mk - 1}^2 mk {mk}"
            got, again = _twice(torch, f"K3 {tag}",
                                lambda: cuda_correlate.psf_gradient_planar(u, err_t))
            ref = cuda_correlate.psf_gradient_plain(u, err_t)
            err, rel = _rel(torch, got, ref)
            worst = max(worst, err)
            line = f"K3 {tag}: max_abs_err {err:.3e} rel {rel:.3e}"
            # the library call: one grouped convolution with the error window
            # as the weight (a cross-correlation), then the flip
            lib_fn = lambda: torch.flip(
                F.conv2d(u[None], err_t[:, None], groups=3)[0], (1, 2))
            ms, plain, lib, dev_ms = _time_turns(
                torch, lambda: cuda_correlate.psf_gradient_planar(u, err_t),
                lambda: cuda_correlate.psf_gradient_plain(u, err_t),
                lib_fn if mk == 9 else None, 20,
            )
            nbytes = 4 * (u.numel() + err_t.numel() + 3 * mk * mk)
            bound = _bound(nbytes, 2 * mk * mk * err_t.numel(), "f32")
            line += (f"; kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain:.4f} ms, "
                     f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})"
                     + (f", library conv2d {lib:.4f} ms" if mk == 9 else ""))
            if mk == 9:
                self.rows["K3"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                                       library_ms=lib, **bound)
            self.report(line)
            self.check(rel <= REL_TOL, f"K3 {tag} within {REL_TOL:g} of its twin")
            self.check(torch.equal(got, again), f"K3 {tag} bitwise reproducible")
            if mk == 9:
                self.lib_agrees(f"K3 {tag}", lib_fn(), ref)
        self.rows.setdefault("K3", {})["max_abs_err"] = worst

    # name: (wrapper in ops/cuda_conv_mma.py, operand dtype, bound against
    # the twin relative to its largest value (None: one bf16 ulp of each
    # value), bf16 products per tap, cases)
    K4_CASES = [
        ("24MP 9x9 valid", (3, 4012, 6012), 9, 9, "valid", 5),
        ("24MP 9x9 full", (3, 4004, 6004), 9, 9, "full", 5),
        ("520^2 9x9 valid", (3, 520, 520), 9, 9, "valid", 20),
        ("369^2 7x7 valid", (3, 369, 369), 7, 7, "valid", 20),
        ("odd width 2837x4251 9x9 full", (3, 2837, 4251), 9, 9, "full", 5),
    ]
    F32_CASES = [
        ("24MP 9x9 valid", (3, 4012, 6012), 9, 9, "valid", 5),
        ("24MP 9x9 full", (3, 4004, 6004), 9, 9, "full", 5),
        ("520^2 9x9 valid", (3, 520, 520), 9, 9, "valid", 20),
        *((f"odd 77x141 9x9 {mode}", (3, 77, 141), 9, 9, mode, 20)
          for mode in ("valid", "same", "full")),
        ("odd 45x101 31x29 same", (3, 45, 101), 31, 29, "same", 20),
    ]
    K4_VARIANTS = {
        "K4s": ("conv_split", "float32", REL_TOL, 3, K4_CASES),
        "K4": ("conv_bf16", "bfloat16", None, 1, K4_CASES),
        "K4h": ("conv_highest", "float32", HIGHEST_TOL, 6, F32_CASES),
        "K4d": ("conv_default", "float32", 1e-6, 1, F32_CASES),
    }

    def k4(self):
        """K4s, K4, K4h and K4d at the 24 MP non-blind shapes; K4s and K4 also
        at the 520^2 op-loop window (what K4s takes under 'high'), the 369^2
        7x7 window and a plane of odd width (a pyramid level's size; K4
        stages it with plain loads); K4h and K4d at the 520^2 window and
        small planes of odd width in every mode, up to 31x29 taps.  K4h's
        and K4d's twins sum in float64.  The
        library call beside K4h is cuDNN's f32 convolution (TF32 off), beside
        K4d the same on the operands rounded to bf16."""
        from ics_tpu_torch.ops import cuda_conv_mma

        torch = self.torch
        for name, (fn, dtype, tol, products, cases) in self.K4_VARIANTS.items():
            kern, plain = getattr(cuda_conv_mma, fn), getattr(cuda_conv_mma, f"{fn}_plain")
            worst = 0.0
            for label, shape, mk, nk, mode, reps in cases:
                a = self.rand(shape).to(getattr(torch, dtype))
                k = self.t(self.rng.uniform(0.05, 1.0, (3, mk, nk))).to(getattr(torch, dtype))
                got, again = _twice(torch, f"{name} {label}", lambda: kern(a, k, mode))
                ref = plain(a, k, mode)
                err, rel = _rel(torch, got, ref)
                first = label == "24MP 9x9 valid"
                if tol is None:
                    ulps = _ulps(torch, got, ref)
                    bound, ok, detail = "within one bf16 ulp of its twin", ulps <= 1.0, \
                        f"{ulps:.2f} bf16 ulp"
                else:
                    bound, ok, detail = f"within {tol:g} of its twin", rel <= tol, f"rel {rel:.3e}"
                line = f"{name} {label}: max_abs_err {err:.3e} {detail}"
                # K4d's library call: the same convolution of the rounded operands
                la, lk = (a.bfloat16().float(), k.bfloat16().float()) if name == "K4d" else (a, k)
                ms, plain_ms, lib, dev_ms = _time_turns(
                    torch, lambda: kern(a, k, mode), lambda: plain(a, k, mode),
                    self.lib_conv(la, lk) if first else None, reps)
                line += (f"; kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms"
                         + (f", library conv2d {lib:.4f} ms" if first else ""))
                if first:
                    # bf16 products of the operands' slices per tap: the
                    # function is the f32 conv for K4s and K4h, the conv of
                    # the bf16-rounded operands for K4d, the bf16 conv for K4
                    itemsize = 2 if dtype == "bfloat16" else 4
                    self.rows[name] = dict(
                        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib,
                        **self.conv_bound(shape, mk, itemsize, "bf16", products))
                self.report(line)
                self.check(ok, f"{name} {label} {bound}")
                self.check(torch.equal(got, again), f"{name} {label} bitwise reproducible")
                if first and name in ("K4h", "K4d"):
                    self.lib_agrees(f"{name} {label}", self.lib_conv(la, lk)()[0], ref)
                worst = max(worst, err)
                del a, got, again, ref, la, lk
            self.rows.setdefault(name, {})["max_abs_err"] = worst

    def k5(self):
        """K5 at the 24 MP non-blind frame, every (order, norm), and bf16 once."""
        from ics_tpu_torch.ops import cuda_tv

        torch, worst = self.torch, 0.0
        u = self.rand((3, 4001, 6001))
        for order, norm, dtype in [(2, 1, torch.float32), (2, 2, torch.float32),
                                   (1, 1, torch.float32), (1, 2, torch.float32),
                                   (2, 2, torch.bfloat16)]:
            x = u.to(dtype)
            tag = f"24MP order {order} L{norm} {str(dtype).split('.')[-1]}"
            got, again = _twice(torch, f"K5 {tag}",
                                lambda: cuda_tv.tv_planar(x, 1e-6, order, norm))
            ref = cuda_tv.tv_planar_plain(x, 1e-6, order, norm)
            errs = [_rel(torch, g, r) for g, r in zip(got, ref)]
            err, rel = max(e for e, _ in errs), max(r for _, r in errs)
            bitwise = all(torch.equal(g, r) for g, r in zip(got, ref))
            line = (f"K5 {tag}: max_abs_err {err:.3e} rel {rel:.3e} (bitwise equal to twin: "
                    f"{bitwise})")
            ms, plain_ms, _, dev_ms = _time_turns(
                torch, lambda: cuda_tv.tv_planar(x, 1e-6, order, norm),
                lambda: cuda_tv.tv_planar_plain(x, 1e-6, order, norm), None, 5)
            line += f"; kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms"
            if (order, norm, dtype) == (2, 2, torch.float32):
                # order 2, L2: about 31 operations per interior pixel; one
                # read, two writes
                self.rows["K5"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                       library_ms=None,
                                       **_bound(4 * 3 * x.numel(), 31 * x.numel(), "f32"))
            self.report(line)
            self.check(rel <= REL_TOL, f"K5 {tag} within {REL_TOL:g} of its twin")
            self.check(all(torch.equal(g, h) for g, h in zip(got, again)),
                       f"K5 {tag} bitwise reproducible")
            worst = max(worst, err)
            del x, got, again, ref
        self.rows.setdefault("K5", {})["max_abs_err"] = worst

    def k6(self):
        """K6 at one 24 MP plane (the CLI's bilateral filters each channel), a
        3-plane crop, a 24 MP L plane on the 0-100 scale (bilateral-lab) and
        a plane smaller than 2r+1 on a side; std_s 5.0, the CLI default."""
        from ics_tpu_torch.ops import cuda_bilateral

        torch, worst = self.torch, 0.0
        for label, shape, radius, std_i, scale, reps in [
            ("24MP plane r5", (1, 4000, 6000), 5, 0.1, 1.0, 3),
            ("3x257x263 r2", (3, 257, 263), 2, 0.1, 1.0, 0),
            ("24MP L plane r5 std_i 5", (1, 4000, 6000), 5, 5.0, 100.0, 0),
            ("7x4 plane r5", (1, 7, 4), 5, 0.1, 1.0, 0),
        ]:
            x = self.rand(shape, scale=scale, offset=0.0)
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
                row = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
                           **_bound(nbytes, ops, "f32", sfu=exps))
                self.rows["K6"] = row
                f32_ms = ops / PEAK_OPS_PER_S["f32"] * 1e3
                sfu_ms, one_each_ms = (e / SFU_OPS_PER_S * 1e3
                                       for e in (exps, offsets * x.numel()))
                line += (f"; bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
                         f"{row['bound_ms'] / ms:.1%} of it): f32 operations "
                         f"{f32_ms:.4f} ms, SFU {sfu_ms:.4f} ms at {(offsets - 1) // 2} "
                         f"exponentials per pixel ({one_each_ms:.4f} ms at one per offset, "
                         f"as this kernel computes them)")
            self.report(line)
            self.check(rel <= REL_TOL, f"K6 {label} within {REL_TOL:g} of its twin")
            self.check(torch.equal(got, again), f"K6 {label} bitwise reproducible")
            worst = max(worst, err)
            del x, got, again, ref
        self.rows.setdefault("K6", {})["max_abs_err"] = worst

    def k7(self):
        """K7 against its twin on this device, bitwise, state by state, over
        M_r sequences that take each branch of the stop (blind, tau, the
        plateau, no stopping, NaN); then one launch timed."""
        from ics_tpu_torch.ops import cuda_outer

        torch, worst = self.torch, 0.0
        falling = [1.0 - 6e-4 * i for i in range(8)]
        for label, seq, kw in [
            ("blind", [5.0, 4.0, 3.0, 3.5, 2.0], dict(blind=True, tau=0.0)),
            ("non-blind tau 1e-4", [3.0, 2.0, 1.9, 1.9001, 1.8, 1.8006],
             dict(blind=False, tau=1e-4)),
            ("plateau", [1.0, 0.9995, 0.999, 0.9988, 0.9987, 0.9986],
             dict(blind=False, tau=1e9, early_stop=1e-3, patience=2)),
            ("slow decrease", falling, dict(blind=False, tau=1e9, early_stop=1e-3, patience=2)),
            ("no stopping", [1.0, 2.0, 3.0], dict(blind=True, tau=0.0, use_stopping=False)),
            ("NaN", [1.0, float("nan"), float("nan")], dict(blind=False, tau=0.0)),
        ]:
            kw = dict(iterations=len(seq), **kw)
            (mr, ints, go), (pmr, pints, pgo) = (
                cuda_outer.initial_state(self.dev, kw["iterations"]) for _ in range(2))
            use, same = kw.get("use_stopping", True), True
            for it, value in enumerate(seq):
                m_r_new = torch.full((), value, dtype=torch.float32, device=self.dev)
                _once(torch, f"K7 {label}, outer {it}", lambda: cuda_outer.outer_stop(
                    m_r_new if use else mr[0], mr, ints, go, **kw))
                cuda_outer.outer_stop_plain(m_r_new if use else pmr[0], pmr, pints, pgo, **kw)
                # bits, so that a NaN M_r compares too
                same = same and torch.equal(mr.view(torch.int32), pmr.view(torch.int32)) \
                    and torch.equal(ints, pints) and torch.equal(go, pgo)
                worst = max(worst, float(torch.nan_to_num(torch.abs(mr - pmr)).max()))
                if not bool(pgo):
                    break
            self.report(f"K7 {label}: [it, since_best, stop, go] {ints.tolist()}, bitwise "
                        f"equal to the twin: {same}")
            self.check(same, f"K7 {label} bitwise equal to its twin at every outer")
        mr, ints, go = cuda_outer.initial_state(self.dev, 10**6)
        pmr, pints, pgo = cuda_outer.initial_state(self.dev, 10**6)
        m_r_new = torch.full((), 0.5, dtype=torch.float32, device=self.dev)
        kw = dict(iterations=10**6, blind=False, tau=1e9, early_stop=1e-3, patience=10**6)
        ms, plain_ms, _, dev_ms = _time_turns(
            torch, lambda: cuda_outer.outer_stop(m_r_new, mr, ints, go, **kw),
            lambda: cuda_outer.outer_stop_plain(m_r_new, pmr, pints, pgo, **kw), None, 20)
        self.report(f"K7: kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms")
        # M_r read; mr and ints read and written; go written
        self.rows["K7"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
                               max_abs_err=worst, **_bound(4 + 2 * (12 + 16) + 1, 10, "f32"))

    def k7w(self):
        """K7w's effect: a WHILE graph over a body of K7 (M_r read from a
        table on the card at index ``it``) runs exactly outers - 1 bodies
        after the eager first, K7w once per outer, one host read, and leaves
        the state bitwise as K7's twin stepped on the host; then one outer
        step of the node (K7 and K7w) timed against the host loop's (K7 and
        a read of the state), over 1000 outers each."""
        from ics_tpu_torch.models import rl_mm
        from ics_tpu_torch.ops import cuda_outer

        torch, worst = self.torch, 0.0
        for label, seq, kw in [
            ("blind", [5.0, 4.0, 3.0, 3.5, 2.0], dict(blind=True, tau=0.0)),
            ("plateau", [1.0, 0.9995, 0.999, 0.9988, 0.9987, 0.9986],
             dict(blind=False, tau=1e9, early_stop=1e-3, patience=2)),
            ("cap", [3.0, 2.0, 1.0, 0.5], dict(blind=False, tau=1e-4)),
            ("no stopping", [1.0, 2.0, 3.0], dict(blind=True, tau=0.0, use_stopping=False)),
        ]:
            kw = dict(iterations=len(seq), **kw)
            table = torch.tensor(seq, dtype=torch.float32, device=self.dev)
            st = rl_mm._Outer(len(seq), bodies=torch.zeros((), dtype=torch.int32,
                                                           device=self.dev))

            def body():
                m_r_new = table.index_select(0, st.ints[:1].long()).reshape(())
                cuda_outer.outer_stop(m_r_new if kw.get("use_stopping", True) else st.mr[0],
                                      st.mr, st.ints, st.go, **kw)
                st.bodies.add_(1)

            before = cuda_outer.while_launches
            try:
                outers = rl_mm._while_loop(body, st, len(seq))
                torch.cuda.synchronize()
            except Exception as exc:
                raise _Fault(f"K7w {label}: {type(exc).__name__}: {exc}") from exc
            k7w = cuda_outer.while_launches - before
            pmr, pints, pgo = cuda_outer.initial_state(self.dev, len(seq))
            while bool(pgo):
                m_r_new = table[int(pints[0])]
                cuda_outer.outer_stop_plain(m_r_new if kw.get("use_stopping", True) else pmr[0],
                                            pmr, pints, pgo, **kw)
            same = torch.equal(st.mr.view(torch.int32), pmr.view(torch.int32)) \
                and torch.equal(st.ints, pints) and torch.equal(st.go, pgo)
            worst = max(worst, float(torch.nan_to_num(torch.abs(st.mr - pmr)).max()))
            log = rl_mm.loop_log[-1]
            self.report(f"K7w {label}: {outers} outers, {int(st.bodies) - 1} bodies in the node, "
                        f"K7w {k7w} (its own count {log['k7w']}), reads {log['reads']}, state "
                        f"bitwise the twin's: {same}")
            self.check(same and int(st.bodies) == outers == int(pints[0]) == log["k7w"] == k7w
                       and log["reads"] == 1,
                       f"K7w {label}: the WHILE node runs outers - 1 bodies, the twin's state")
        ms, plain_ms = self._k7w_times(cuda_outer, 1000)
        self.report(f"K7w: one outer step of the WHILE node {ms:.4f} ms, of the host loop "
                    f"{plain_ms:.4f} ms")
        # K7's state (61 bytes), the byte of go that K7w reads and its runs
        # (an int32 read and written)
        self.rows["K7w"] = dict(ms=ms, device_ms=ms, plain_ms=plain_ms, library_ms=None,
                                max_abs_err=worst, **_bound(61 + 1 + 8, 10, "f32"))

    def _k7w_times(self, cuda_outer, n):
        """(ms per outer of one WHILE launch over a body of K7 alone, ms per
        outer of the host loop over the same body), each the median of 5
        runs of ``n`` outers; the WHILE graph is built once."""
        torch = self.torch
        kw = dict(iterations=n, blind=True, tau=0.0, use_stopping=False)
        mr, ints, go = cuda_outer.initial_state(self.dev, n)
        start, runs = ints.clone(), torch.zeros(1, dtype=torch.int32, device=self.dev)
        body = lambda: cuda_outer.outer_stop(mr[0], mr, ints, go, **kw)
        body()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(torch.cuda.Stream(self.dev)):
            graph.capture_begin(capture_error_mode="thread_local")
            body()
            graph.capture_end()
        handles = cuda_outer.while_build(graph.raw_cuda_graph(), go, runs)

        def node():
            ints.copy_(start)
            runs.zero_()
            go.fill_(True)
            cuda_outer.while_launch(handles, self.dev)

        def host():
            ints.copy_(start)
            more = True
            while more:
                body()
                more = ints.tolist()[3]

        try:
            node_ms = _median_ms(torch, node, 5)
            host_ms = _median_ms(torch, host, 5)
            node_ms = (node_ms + _median_ms(torch, node, 5)) / 2
            torch.cuda.synchronize()
            # no eager outer here: K7w runs before the node and after each of
            # its n bodies
            if int(ints[0]) != n or int(runs) != n + 1:
                raise _Fault(f"K7w timing: the node ran {int(ints[0])} outers and K7w "
                             f"{int(runs)} times, not {n} and {n + 1}")
        finally:
            cuda_outer.while_free(*handles)
            graph.reset()
        return node_ms / n, host_ms / n

    def resize(self):
        """The banded resize kernel against its dense twin at the 24 MP
        frame's widest band (the 0.354 level's downscale of the frame) and
        at its largest output (the final level's upscale of the estimate),
        each pass on the twin's input, within RESIZE_TOL of the largest
        value; the two passes of each resize timed together."""
        from ics_tpu_torch.ops import cuda_resize
        from ics_tpu_torch.utils.resize import band_tables

        torch, worst = self.torch, 0.0
        for label, shape, out in [("24MP 0.354 downscale", (4003, 6003, 3), (1415, 2123)),
                                  ("24MP 1.0 upscale", (2829, 4245, 3), (4003, 6003))]:
            x = self.rand(shape)
            nbytes = ops = 0
            y = x
            for axis, n in enumerate(out):
                got, again = _twice(torch, f"resize {label} axis {axis}",
                                    lambda: cuda_resize.resample(y, axis, n))
                ref = cuda_resize.resample_plain(y, axis, n)
                err, rel = _rel(torch, got, ref)
                self.report(f"resize {label} axis {axis} {tuple(y.shape)} -> {n}: max_abs_err "
                            f"{err:.3e} rel {rel:.3e} (bitwise equal to twin: "
                            f"{torch.equal(got, ref)})")
                self.check(rel <= RESIZE_TOL,
                           f"resize {label} axis {axis} within {RESIZE_TOL:g} of its twin")
                self.check(torch.equal(got, again),
                           f"resize {label} axis {axis} bitwise reproducible")
                worst = max(worst, err)
                # each pass reads its input and writes its output once; 2 flops a tap
                nbytes += 4 * (y.numel() + ref.numel())
                taps = int(band_tables(y.shape[axis], n)[1].sum())
                ops += 2 * taps * (y.numel() // y.shape[axis])
                y = ref
                del got, again
            ms, plain_ms, _, dev_ms = _time_turns(
                torch, lambda: cuda_resize.resample(cuda_resize.resample(x, 0, out[0]), 1, out[1]),
                lambda: cuda_resize.resample_plain(cuda_resize.resample_plain(x, 0, out[0]), 1,
                                                   out[1]), None, 10)
            bound = _bound(nbytes, ops, "f32")
            self.report(f"resize {label} {shape} -> {out}: kernel {ms:.4f} ms (device "
                        f"{dev_ms:.4f}), dense twin {plain_ms:.4f} ms, bound "
                        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
                        f"{100 * bound['bound_ms'] / dev_ms:.1f} % of it by device time")
            if "upscale" in label:
                self.rows["resize"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                           library_ms=None, **bound)
            del x, y
        self.rows.setdefault("resize", {})["max_abs_err"] = worst

    def k8(self):
        """K8 at the 24 MP full-frame window (3x4009x6009: the frame padded to
        odd sizes, 4001x6001, the crop at pad 4 for mk 9), non-blind (lambd 1e4
        and 1000/3, whose float32 reciprocal PyTorch rounds from float64) and
        blind, against the ops of ``mm_step_plain`` it replaces: bitwise (NaN
        at the same places), twice; then both passes timed beside the ops."""
        from ics_tpu_torch.ops import cuda_step

        torch = self.torch
        c, um, un, m, n = 3, 4009, 6009, 4001, 6001
        u = self.rand((c, um, un))
        ut = u + (self.rand((c, um, un)) - 0.5) * 1e-3
        gradu = u * 0.9 + (self.rand((c, um, un)) - 0.5) * 2e-4
        img = self.rand((c, m, n))
        worst = 0.0
        for blind, lambd in ((False, 1e4), (False, 1000 / 3), (True, 1e4)):
            kw = dict(step_factor=1e-3, lambd=lambd, blind=blind)
            tag = f"K8 {c}x{um}x{un} blind={blind} lambd={lambd:g}"
            got, again = _twice(torch, tag, lambda: cuda_step.mm_step(u, ut, gradu, img, **kw))
            ref = cuda_step.mm_step_plain(u, ut, gradu, img, **kw)
            err, rel = _rel(torch, got, ref)
            worst = max(worst, err)
            self.report(f"{tag}: max_abs_err {err:.3e} rel {rel:.3e} against the ops")
            self.check(_same_bits(torch, got, ref), f"{tag} bitwise equal to the ops")
            self.check(_same_bits(torch, got, again), f"{tag} bitwise reproducible")
            del got, again, ref
        kw = dict(step_factor=1e-3, lambd=1e4, blind=False)
        ms, plain_ms, _, dev_ms = _time_turns(
            torch, lambda: cuda_step.mm_step(u, ut, gradu, img, **kw),
            lambda: cuda_step.mm_step_plain(u, ut, gradu, img, **kw), None, 10)
        # pass A reads gradu, u and ut; pass B reads them again with the
        # image on the crop and writes u': 8 plane-set passes (the work alone
        # needs 5); some 20 f32 operations an element
        n_u = c * um * un
        bound = _bound(4 * (7 * n_u + c * m * n), 20 * n_u, "f32")
        self.report(f"K8 {c}x{um}x{un} non-blind, both passes: kernel {ms:.4f} ms (device "
                    f"{dev_ms:.4f}), the ops {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
                    f"({bound['bound_by']}), {100 * bound['bound_ms'] / dev_ms:.1f} % of it by "
                    f"device time")
        self.rows["K8"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
                               max_abs_err=worst, **bound)

    def inner_loop_routes(self):
        """The K2 inner loop (``inner_loop='pallas'``) against the op loop
        (``'xla'``, K1 and K3) on one 255^2 blind solve of 3 outers: u
        within 1e-5, the PSF within 1e-4 (the JAX file's check 6)."""
        from ics_tpu_torch.models.rl_mm import RLConfig, richardson_lucy_MM

        small = make_scene(255, 255, 7, seed=6)[1].astype(np.float32) / 255.0
        u0 = np.pad(small, ((3, 3), (3, 3), (0, 0)), mode="edge")
        psf0 = np.ones((7, 7, 3), np.float32) / 49.0

        def run(inner):
            return richardson_lucy_MM(
                small, u0, psf0, 8, 247, 8, 247, 0.0, iterations=3, step_factor=1e-3,
                lambd=10000, blind=True, config=RLConfig(inner_loop=inner), verbose=False,
                device=self.dev)

        want = run("xla")
        got = _twice(self.torch, "K2 inner loop 261^2 mk 7, 3 blind outers", lambda: run("pallas"))[0]
        for name, tol in (("u", 1e-5), ("psf", 1e-4)):
            _, rel = _rel(self.torch, getattr(got, name), getattr(want, name))
            self.report(f"inner loop 'pallas' (K2) vs 'xla' (op loop) {name}: rel {rel:.3e}")
            self.check(rel <= tol, f"solver inner loop K2 vs op loop ({name}) within {tol:g}")

    def glue(self):
        """The pipeline's preprocess, postprocess and cubic resize against
        the same steps one torch op at a time on this device, within 1e-6
        (the JAX file's check 8)."""
        from ics_tpu_torch.models.pipeline import _postprocess, _preprocess
        from ics_tpu_torch.utils.resize import resize_jax, weight_matrix

        torch, F = self.torch, self.F
        raw = make_scene(256, 384, 5, seed=8)[1]
        img = self.t(raw) / 255.0
        x = torch.from_numpy(raw).to(self.dev).to(torch.float32)
        x = F.pad(x.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")[0]
        x = x.permute(1, 2, 0)
        x = x / 255
        pre = torch.pow(x, 1 / 2.2)
        clipped = torch.clamp(img, 0.0, 1.0)
        clipped = clipped ** 2.2
        post = (clipped * (2**16 - 1)).to(torch.int32)
        wh = weight_matrix(256, 361, str(self.dev))
        ww = weight_matrix(384, 452, str(self.dev))
        rows = torch.einsum("hi,hwc->iwc", wh, img)
        rsz = torch.einsum("iwc,wj->ijc", rows, ww)
        for name, got, want in [
            ("preprocess", lambda: _preprocess(raw, 255, self.dev), pre),
            ("postprocess", lambda: _postprocess(img)[0], post),
            ("resize", lambda: resize_jax(img, (361, 452)), rsz),
        ]:
            _, rel = _rel(torch, got(), want)
            self.report(f"glue {name} against one op at a time: rel {rel:.3e}")
            self.check(rel <= 1e-6, f"glue {name} within 1e-6 of one op at a time")


def certify_kernels(report=print, device="cuda", rows: dict | None = None) -> bool:
    """Run every CUDA kernel against its plain twin on ``device`` at the 24 MP
    path's shapes, each twice (bitwise reproducible), timed against its
    twin and the library call that computes the same function (which must
    agree with the twin), then the K2 inner loop against the op loop and
    the pipeline's glue against one op at a time.  Returns True when every
    check passes.

    A kernel call that raises ends the run (CUDA may have lost its context):
    it is reported as ``[selftest] ERROR <kernel and shape>, <which call>:
    ...``.  ``rows`` (a dict), when given, gets each kernel's ``ms``,
    ``device_ms``, ``plain_ms``, ``library_ms``, ``bound_ms``, ``bound_by``
    and ``max_abs_err`` under its name.  Raises ``RuntimeError`` without a
    GPU: the kernels have no CPU path.
    """
    import torch

    dev = _cuda(device)
    check = _Checks(report)
    cert = _Certify(torch, dev, check, report, {} if rows is None else rows)
    for section in (cert.k1, cert.k2, cert.k3, cert.k4, cert.k5, cert.k6, cert.k7, cert.k7w,
                    cert.k8, cert.resize, cert.inner_loop_routes, cert.glue):
        try:
            section()
        except _Fault as exc:
            report(f"[selftest] ERROR {exc}")
            check.failed.append(str(exc))
            break
    report(f"[selftest] {torch.cuda.get_device_name(dev)}: "
           f"{check.count - len(check.failed)}/{check.count} checks passed"
           + (f"; first failure: {check.failed[0]}" if check.failed else ""))
    return not check.failed


# ------------------------------------------------------------- benchmarks
# bench_conv_backends' kernel names: K4s is 'auto' at precision 'high', K4h
# and K4d 'pallas_mxu' at 'exact' and 'fast', cudnn the yardstick
CONV_BENCH_KERNELS = ("K1", "K4s", "K4", "K4h", "K4d", "cudnn")


def bench_conv_backends(shapes=((2048, 3072), (4005, 6005)), dtypes=("float32", "bfloat16"),
                        mk=9, methods=("pallas", "pallas_mxu", "mxu"), report=print, *,
                        device="cuda", n_iter=20, reps=3, kernels=()):
    """ms per call of the 'same'-mode mk x mk per-channel conv on a
    ``make_scene`` frame of each shape: ``convolve_rgb(method=...)`` on the
    (H, W, C) frame in each of ``dtypes``, then each of ``kernels``
    (``CONV_BENCH_KERNELS``) on the planar frame in its operand dtype: K1,
    K4s, K4h and K4d on float32, K4 on bfloat16, and cuDNN's grouped
    ``conv2d`` in float32 with TF32 off.  Each is timed as a chain of
    ``n_iter`` calls, every call taking the last one's output, between two
    CUDA events with one sync at the end; the best of ``reps`` chains.
    Returns {(h, w, dtype, method or kernel): ms}.  A call that fails raises
    (JAX's records ``None``)."""
    import torch
    import torch.nn.functional as F

    from ics_tpu_torch.ops import cuda_conv, cuda_conv_mma
    from ics_tpu_torch.ops.conv import convolve_rgb

    dev = _cuda(device)
    rng = np.random.default_rng(2)
    kern = np.abs(rng.random((3, mk, mk))).astype(np.float32)
    kern /= kern.sum(axis=(1, 2), keepdims=True)  # magnitude-preserving chain
    k32 = torch.from_numpy(kern).to(dev)
    planar = {
        "K1": (torch.float32, lambda a, k: cuda_conv.conv_planar(a, k, "same")),
        "K4s": (torch.float32, lambda a, k: cuda_conv_mma.conv_split(a, k, "same")),
        "K4": (torch.bfloat16, lambda a, k: cuda_conv_mma.conv_bf16(a, k, "same")),
        "K4h": (torch.float32, lambda a, k: cuda_conv_mma.conv_highest(a, k, "same")),
        "K4d": (torch.float32, lambda a, k: cuda_conv_mma.conv_default(a, k, "same")),
        "cudnn": (torch.float32, lambda a, k: F.conv2d(
            a[None], torch.flip(k, (1, 2))[:, None], padding=mk // 2, groups=3)[0]),
    }

    def best_ms(fn, x0, k):
        def chain():
            x = x0
            for _ in range(n_iter):
                x = fn(x, k)
            return x

        chain()  # warm (and build)
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / n_iter)
        return best

    results = {}
    for h, w in shapes:
        base = torch.from_numpy(np.ascontiguousarray(
            make_scene(h, w, mk, seed=h)[0].transpose(2, 0, 1))).to(dev)
        runs = [(dtype, method, base.permute(1, 2, 0), k32.permute(1, 2, 0),
                 lambda a, k, method=method: convolve_rgb(a, k, mode="same", method=method))
                for dtype in dtypes for method in methods]
        runs += [(str(planar[name][0]).split(".")[-1], name, base, k32, planar[name][1])
                 for name in kernels]
        for dtype, name, x, k, fn in runs:
            ms = best_ms(fn, x.to(getattr(torch, dtype)), k.to(getattr(torch, dtype)))
            results[(h, w, dtype, name)] = ms
            report(f"[conv-bench] {h}x{w} {dtype} {name}: {ms:.3f} ms")
        del base, runs
    return results


def _scaling_rank(rank, n, port, device_type, m, n_cols, mk, iterations, reps, out):
    """One rank of ``bench_scaling``: the row-sharded non-blind solve, warm,
    then the best of ``reps``; rank 0 saves seconds per outer to ``out``."""
    import torch
    import torch.distributed as dist

    from ics_tpu_torch.parallel import initialize, make_mesh, sharded_richardson_lucy

    if device_type == "cpu":  # the ranks share the cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    initialize(f"127.0.0.1:{port}", n, rank, device=device_type)
    try:
        mesh = make_mesh(n, device=device_type)
        pad = mk // 2
        img = make_scene(m, n_cols, mk, seed=5)[1].astype(np.float32) / 255.0
        u = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        psf = np.ones((mk, mk, 3), np.float32) / (mk * mk)

        def run():
            res = sharded_richardson_lucy(
                img, u, psf, pad + 1, m - pad - 1, pad + 1, m - pad - 1, 0.0, mesh=mesh,
                iterations=iterations, step_factor=1e-3, lambd=10000.0, blind=False,
                use_stopping=False)
            float(res.stats[0])  # waits for the device
            dist.barrier()

        run()  # warm
        best = float("inf")
        for _ in range(reps):
            dist.barrier()
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        if rank == 0:
            np.save(out, np.array(best / iterations))
    finally:
        dist.destroy_process_group()


def bench_scaling(m=511, n=767, mk=9, iterations=6, ns=(1, 2, 4, 8), reps=3, report=print,
                  device="cuda"):
    """Seconds per outer of the row-sharded non-blind solve
    (``parallel.sharded_richardson_lucy``, ``use_stopping=False``: exactly
    ``iterations`` outers) on each rank count of ``ns``, each rank a spawned
    process: NCCL ranks with a GPU each on CUDA (rank counts above
    ``torch.cuda.device_count()`` are skipped), gloo ranks on the CPU.
    Returns {ranks: seconds per outer}."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from ics_tpu_torch._device import resolve_device
    from ics_tpu_torch.cli import _free_port

    dev = resolve_device(device)
    available = torch.cuda.device_count() if dev.type == "cuda" else (os.cpu_count() or 1)
    what = "devices" if dev.type == "cuda" else "CPU cores"
    results, t1 = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        for nd in ns:
            if nd > available:
                report(f"[scaling] n={nd}: skipped (only {available} {what})")
                continue
            out = os.path.join(tmp, f"n{nd}.npy")
            port = _free_port()
            mp.start_processes(_scaling_rank, nprocs=nd, join=True, start_method="spawn",
                               args=(nd, port, dev.type, m, n, mk, iterations, reps, out))
            per_outer = float(np.load(out))
            results[nd] = per_outer
            t1 = t1 or per_outer
            report(f"[scaling] n={nd}: {per_outer * 1e3:.1f} ms/outer "
                   f"(t_n/t_1 = {per_outer / t1:.2f})")
    return results


# --------------------------------------------- the blind-restoration battery
def _sharp_frame(fallback_size: int = 512, reference=None) -> np.ndarray:
    """The reference's SHARP fixture, full frame (uint8 HxWx3) — the sharp
    half of the blured/original pair its published benchmark is built on
    (ref img/README.md); deterministic random stand-in where it is absent."""
    path = _fixture(reference, "original.jpg")
    if path is not None:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im, np.uint8)
    rng = np.random.default_rng(3)
    base = rng.random((fallback_size, fallback_size, 1)).astype(np.float32)
    return (np.repeat(base, 3, axis=-1) * 255).astype(np.uint8)


def _sharp_crop(size: int, reference=None) -> np.ndarray:
    """Highest-detail size² crop of the reference's SHARP fixture (uint8).

    The crop maximizes mean |gradient| over a coarse grid: a SMOOTH crop
    makes the success metric trivial (blur barely moves the display-space
    error), so the battery runs on detail, where restoring to < 5% requires
    actually deblurring."""
    arr = _sharp_frame(fallback_size=size * 2, reference=reference)
    h, w = arr.shape[:2]
    g = np.asarray(arr, np.float32).mean(axis=-1)
    best, top, left = -1.0, 0, 0
    for t in range(0, h - size + 1, max(1, size // 2)):
        for l in range(0, w - size + 1, max(1, size // 2)):
            win = g[t : t + size, l : l + size]
            detail = float(
                np.abs(np.diff(win, axis=0)).mean()
                + np.abs(np.diff(win, axis=1)).mean()
            )
            if detail > best:
                best, top, left = detail, t, l
    return np.ascontiguousarray(arr[top : top + size, left : left + size])


def _blob_kernel(size: int, seed: int) -> np.ndarray:
    """Soft irregular broad PSF — the class the reference's own synthetic
    pair was made with (see ``_fitted_kernel``): a mildly center-weighted
    ragged blob with mass over the full support."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] - (size - 1) / 2.0
    radial = 0.5 + 2.6 * np.exp(-(yy**2 + xx**2) / (2 * (size / 3.5) ** 2))
    ragged = np.clip(
        1.0 + 0.5 * gaussian_filter(rng.standard_normal((size, size)), 0.8),
        0.3, 1.7,
    )
    k = radial * ragged
    return (k / k.sum()).astype(np.float32)


def _fitted_kernel(reference=None) -> np.ndarray:
    """The reference's OWN blur, recovered: least-squares fit of the 7x7
    display-space kernel mapping img/original.jpg to img/blured.jpg,
    clipped to >= 0 and normalized.  Fallback: the blob class it belongs
    to."""
    o_path, b_path = _fixture(reference, "original.jpg"), _fixture(reference, "blured.jpg")
    if o_path is None or b_path is None:
        return _blob_kernel(7, 5)
    from PIL import Image

    with Image.open(o_path) as im:
        og = np.asarray(im, np.float64).mean(-1) / 255.0
    with Image.open(b_path) as im:
        bg = np.asarray(im, np.float64).mean(-1) / 255.0
    ys, xs = np.mgrid[420:680:4, 420:680:4]
    ys, xs = ys.ravel(), xs.ravel()
    cols = [og[ys + dy, xs + dx]
            for dy in range(-3, 4) for dx in range(-3, 4)]
    k, *_ = np.linalg.lstsq(np.stack(cols, axis=1), bg[ys, xs], rcond=None)
    k = np.clip(k.reshape(7, 7), 0.0, None)
    return (k / k.sum()).astype(np.float32)


def make_success_battery(noise_sigma: float = 1.0, reference=None):
    """The (name, psf, noise) battery behind ``bench_success_rate``:
    defocus / soft-lens blurs (ref README.md:103), tight Gaussians as the
    method's hard cases, two noisy cases (``noise`` is the display-space
    Gaussian sigma in 8-bit counts) and two linear-motion PSFs, whose
    "motion" prefix makes ``bench_success_rate`` drive blur="motion"."""
    from ics_tpu_torch.ops import windows

    fitted = _fitted_kernel(reference)
    return [
        ("uniform-5", windows.uniform_kernel(5), 0.0),
        ("uniform-7", windows.uniform_kernel(7), 0.0),
        ("fitted-7", fitted, 0.0),
        ("blob-7", _blob_kernel(7, 5), 0.0),
        ("blob-9", _blob_kernel(9, 6), 0.0),
        ("lens-7", windows.lens_blur(14), 0.0),
        ("gauss-5", windows.gaussian_kernel(5, 2.0), 0.0),
        ("gauss-7", windows.gaussian_kernel(7, 2.0), 0.0),
        ("uniform-7-noise", windows.uniform_kernel(7), noise_sigma),
        ("fitted-7-noise", fitted, noise_sigma),
        ("motion-7-h", windows.motion_kernel(7, 0.0), 0.0),
        ("motion-9-45", windows.motion_kernel(9, 45.0), 0.0),
    ]


def synth_blur_case(sharp8: np.ndarray, psf: np.ndarray, noise_sigma: float,
                    seed: int = 7) -> np.ndarray:
    """Synthesize a blind-deblur input: blur the sharp frame in LINEAR
    light (the physical model the pipeline's de-gamma assumes, ref
    deconvolve.py:102-103), re-gamma, add display-space sensor noise,
    quantize to uint8."""
    from scipy.signal import convolve2d

    lin = (sharp8.astype(np.float32) / 255.0) ** 2.2
    blurred = np.dstack(
        [
            convolve2d(lin[..., c], psf, mode="same", boundary="symm")
            for c in range(3)
        ]
    )
    disp = np.clip(blurred, 0.0, 1.0) ** (1 / 2.2) * 255.0
    if noise_sigma:
        rng = np.random.default_rng(seed)
        disp = disp + rng.normal(0.0, noise_sigma, disp.shape)
    return np.clip(np.rint(disp), 0, 255).astype(np.uint8)


def rel_error(out16: np.ndarray, sharp8: np.ndarray) -> float:
    """Relative L2 error of a pipeline output (uint16, same spatial dims
    as the input frame) against the sharp uint8 original, in display
    (gamma) space — the space the reference's images live in."""
    got = np.asarray(out16, np.float64) / 65535.0
    want = np.asarray(sharp8, np.float64) / 255.0
    return float(
        np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    )


def _free_device(device) -> None:
    """Drop the device's cached blocks before host scoring."""
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def bench_success_rate(size=None, iterations=200, mask_size=255, report=print, solver="mm",
                       device="cuda", reference=None):
    """Blind-restoration success battery (the JAX file's protocol): blur
    the reference's sharp frame with each ``make_success_battery`` PSF,
    run the full blind + non-blind ``deblur_module`` on ``device`` given
    only the blur width and the reference's own driving parameters
    (quality 'normal', tolerance 0.1, ``iterations``), and score the
    output against the sharp frame on the host, in display space:

        success := restored rel-L2 error < 5 %  AND  SSIM(restored) >
        SSIM(blurred input)

    ``size`` crops the canvas (highest-detail size² crop, centered mask)
    for cheap runs; the default runs the full frame with the v29 mask
    (``_sharp_frame``'s 512² stand-in where the fixture is absent, with a
    centred mask: the JAX file's v29 mask does not fit it).  ``reference``
    is the directory of the reference's images, read-only; None runs on
    the stand-in.  A diverged solve is no exception in the port (the
    pipeline warns and returns the frame), so it scores as a failed case;
    every error the solve raises, a kernel's fault included, propagates.
    Returns ``(success_rate, rows)``; each row is ``(name, input_err,
    output_err, input_ssim, output_ssim, success)``.
    """
    from ics_tpu_torch.models.pipeline import deblur_module
    from ics_tpu_torch.utils.metrics import ssim

    if size is None:
        sharp8 = _sharp_frame(reference=reference)
        h, w = sharp8.shape[:2]
        if 584 + mask_size // 2 < h and 795 + mask_size // 2 < w:
            mask_kw = {"mask": [584, 795], "mask_size": mask_size}
        else:  # the 512^2 stand-in, where the v29 mask does not fit: centred
            mask_kw = {"mask_size": mask_size}
    else:
        sharp8 = _sharp_crop(size, reference)
        mask_kw = {"mask_size": mask_size}
    want = np.asarray(sharp8, np.float64) / 255.0
    rows = []
    for name, psf, noise in make_success_battery(reference=reference):
        # motion-* cases run the reference's blur="motion" mode
        blur = "motion" if name.startswith("motion") else "static"
        blurred = synth_blur_case(sharp8, psf, noise)
        in_err = float(np.linalg.norm(blurred / 255.0 - want) / np.linalg.norm(want))
        in_ssim = float(ssim(blurred / 255.0, want, device="cpu"))
        out = deblur_module(
            blurred, f"success-{name}", None, blur_width=psf.shape[0], blur=blur,
            tolerance=0.1, quality="normal", iterations=iterations, display=False,
            preview=False, verbose=False, solver=solver, device=device, **mask_kw,
        )
        _free_device(device)
        err = rel_error(out, sharp8)
        out_ssim = float(ssim(np.asarray(out, np.float64) / 65535.0, want, device="cpu"))
        success = err < 0.05 and out_ssim > in_ssim
        rows.append((name, in_err, err, in_ssim, out_ssim, success))
        report(
            f"[success] {name:<16} err {in_err * 100:5.2f}% -> "
            f"{err * 100:5.2f}%  ssim {in_ssim:.4f} -> {out_ssim:.4f}  "
            f"{'SUCCESS' if success else 'fail'}"
        )
    rate = sum(r[-1] for r in rows) / len(rows)
    report(
        f"[success] rate: {sum(r[-1] for r in rows)}/{len(rows)} "
        f"= {rate * 100:.0f}%  (reference claim: >50%, ref README.md:146-148)"
    )
    return rate, rows


def _precision_truth(reference=None) -> np.ndarray:
    """The 24 MP sharp truth: ``153412.jpg`` upscaled to 6000x4000, else the
    deterministic stand-in, ``_sharp_frame`` tiled to the full 4000x6000
    (the JAX file's (8, 6) tiles of the 512^2 frame stop at 3072 columns,
    where the 24 MP case's mask at column 3000 does not fit)."""
    src = _fixture(reference, "153412.jpg")
    if src is not None:
        from PIL import Image

        with Image.open(src) as im:
            return np.asarray(im.resize((6000, 4000), Image.LANCZOS), np.uint8)
    frame = _sharp_frame(reference=reference)
    reps = (-(-4000 // frame.shape[0]), -(-6000 // frame.shape[1]), 1)
    return np.tile(frame, reps)[:4000, :6000]


def bench_precision_quality(modes=("float32", "high", "mixed"), iterations=200,
                            report=print, device="cuda", reference=None):
    """Quality of each precision mode at the 24 MP geometry against the
    sharp truth (the JAX file's protocol): the truth is ``_precision_truth``,
    blurred in linear light with the 9x9 blob PSF (``_blob_kernel(9, 6)``)
    and quantized to uint8 (``synth_blur_case``); each mode runs the full
    blind + non-blind ``deblur_module`` on ``device`` with the 24 MP case's
    kwargs (blur_width 9, mask 511 at [2000, 3000], tolerance 0.1, quality
    'normal'), and is scored on the host against the truth (SSIM, PSNR)
    and against the same run's float32 output (SSIM).  ``reference`` is the
    directory of the reference's images; None runs on the stand-in.

    Returns {mode: {"ssim", "psnr", "ssim_vs_f32", "elapsed_s",
    "outers"}, "input": {"ssim", "psnr"}}.
    """
    from ics_tpu_torch.models.pipeline import deblur_module
    from ics_tpu_torch.utils.metrics import psnr, ssim

    sharp8 = _precision_truth(reference)
    blurred = synth_blur_case(sharp8, _blob_kernel(9, 6), 0.0)
    want = np.asarray(sharp8, np.float64) / 255.0
    in_ssim = float(ssim(blurred / 255.0, want, device="cpu"))
    in_psnr = float(psnr(blurred / 255.0, want, device="cpu"))
    report(f"[prec-quality] blurred input: SSIM {in_ssim:.4f} PSNR {in_psnr:.2f}")

    results = {}
    f32_out = None
    for mode in modes:
        stats = []
        t0 = time.perf_counter()
        out = deblur_module(
            blurred, f"prec-{mode}", None, blur_width=9, mask=[2000, 3000], mask_size=511,
            tolerance=0.1, quality="normal", iterations=iterations, display=False,
            preview=False, verbose=False, precision="exact" if mode == "float32" else mode,
            stats_out=stats, device=device,
        )
        elapsed = time.perf_counter() - t0
        outers = int(sum(s["result"].iterations for s in stats))
        del stats
        _free_device(device)
        got = np.asarray(out, np.float64) / 65535.0
        row = {
            "ssim": round(float(ssim(got, want, device="cpu")), 4),
            "psnr": round(float(psnr(got, want, device="cpu")), 2),
            "elapsed_s": round(elapsed, 2),
            "outers": outers,
        }
        if mode == "float32":
            f32_out = got
        if f32_out is not None:
            row["ssim_vs_f32"] = round(float(ssim(got, f32_out, device="cpu")), 4)
        results[mode] = row
        report(f"[prec-quality] {mode:<8} SSIM {row['ssim']:.4f}  "
               f"PSNR {row['psnr']:.2f}  vs-f32 "
               f"{row.get('ssim_vs_f32', float('nan')):.4f}  "
               f"{row['elapsed_s']:.1f}s  {row['outers']} outers")
    results["input"] = {"ssim": round(in_ssim, 4), "psnr": round(in_psnr, 2)}
    return results
