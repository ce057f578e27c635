"""K2: the RL-MM inner loop in one kernel launch (csrc/inner_loop.cu), and
the op-level inner loop: K2's plain twin in parity mode, and what the solver
runs on larger windows and in the modes K2 does not take (guard, mixed,
bfloat16, use_tv).

Counterpart of ics_tpu/ops/pallas_solver.py (``inner_loop_pallas``) and of
the ``lax.scan`` inner loop of ics_tpu/models/rl_mm.py.  All arrays are
planar (C, H, W); K2 takes float32 only.  On CPU tensors ``inner_loop_planar``
runs the plain twin; on CUDA tensors it launches the kernel or raises.  The
kernel runs one 512-thread block per SM over 2-D tiles of the window and
crosses four grid barriers per blind inner iteration (three non-blind).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ics_tpu_torch import _build
from ics_tpu_torch.ops.cuda_conv import conv_planar_plain
from ics_tpu_torch.ops.cuda_correlate import psf_gradient_plain

__all__ = ["fits", "inner_loop_ops", "inner_loop_plain", "inner_loop_planar"]

INNER_ITER = 5  # ref lib/deconvolution.pyx:375
MAX_TAPS_SIDE = 31  # csrc/inner_loop.cu kMaxK
# The JAX package's window bound for its one-launch inner loop,
# ics_tpu/ops/pallas_solver.py:50-53 (fits_vmem): eight 3-channel float32
# window buffers under 10 MiB.  Kept as is, so the port runs K2, and the op
# loop with K1 and K3, on the windows where the TPU ran each.
FITS_BUDGET_BYTES = 10 * 2**20
launches = 0  # kernel launches by inner_loop_planar (the twin never counts)


def fits(u_m: int, u_n: int) -> bool:
    """True when a (3, u_m, u_n) window takes the one-launch inner loop."""
    return 8 * (3 * u_m * u_n * 4) < FITS_BUDGET_BYTES


def inner_loop_ops(u, image, psf, *, step_factor, lambd, blind, correlation,
                   conv, psf_grad, guard=False, mixed=False, tv=None):
    """One outer iteration's five inner iterations as separate tensor ops
    (ics_tpu/models/rl_mm.py:377-531).

    ``conv(a, k, mode)`` and ``psf_grad(u, err)`` are the planar convolution
    and PSF-gradient backends; the dtype of ``u``, ``image`` and ``psf`` is
    the compute dtype.  ``guard`` is the DoF guard (RLConfig.dof_guard).
    ``mixed``: float32 state with bf16 convolutions and the residual carried
    in f32, updated by the bf16 convolution of each step's increment and
    refreshed in f32 here, at the start of the outer.  ``tv(a, norm) ->
    (magnitude, div)`` turns on the ``use_tv`` regularizer and the
    denoising of ``image``.  Returns (u', psf', error, image'): ``error`` is
    the last residual (post-update when blind), the one the whiteness
    metric reads.
    """
    c, u_m, u_n = u.shape
    _, m, n = image.shape
    mk = psf.shape[1]
    pad = (u_m - m) // 2
    sf = torch.tensor(step_factor, dtype=torch.float32, device=u.device)
    inv_un = 1.0 / (u_m * u_n)
    ut = u
    psf_rot = torch.flip(psf, dims=(1, 2)).contiguous()
    # mixed: bf16 convolution operands, f32 results (rl_mm.py:368-375)
    lo = (lambda a: a.to(torch.bfloat16)) if mixed else (lambda a: a)
    hi = (lambda a: a.float()) if mixed else (lambda a: a)
    if tv is not None:
        tv_ut_l1, _ = tv(ut, 1)
        tv_ut_l2, _ = tv(ut, 2)
    error = None
    if mixed:
        error = conv(u, psf, "valid") - image
        delta = torch.zeros_like(u)
    for _ in range(INNER_ITER):
        u_start = u
        # 1. residual (mixed: by linearity, plus the increment's conv);
        # 2. correlate it with the PSF
        if mixed:
            error = error + hi(conv(lo(delta), lo(psf), "valid"))
        else:
            error = conv(u, psf, "valid") - image
        gradu = hi(conv(lo(error), lo(psf_rot), "full"))
        # 3. TV stencils of u (order 2, as at the reference's call sites)
        if tv is not None:
            tv_u_l1, _ = tv(u, 1)
            tv_u_l2, div = tv(u, 2)
        # 4. depth-of-field weights from the raw correlation (no epsilon);
        # the guard keeps the observed pixel where the denominator is 0
        # and caps dof at 1
        gcrop = gradu[:, pad : pad + m, pad : pad + n]
        if guard:
            den = gcrop + image
            zero = den == 0.0
            dof = torch.where(zero, 1.0, ((gcrop - image) / torch.where(zero, 1.0, den)) ** 2)
        else:
            dof = ((gcrop - image) / (gcrop + image)) ** 2
        if not blind:
            dof = dof / lambd
        if guard:
            dof = torch.clamp(dof, max=1.0)
        # 5. regularization: parity mode, or the live/dead MM step of use_tv
        if tv is not None:
            live = (tv_ut_l1 != 0.0) & (tv_u_l1 != 0.0)
            reg = div / tv_u_l1 / tv_ut_l1 / 2.0 + div / tv_u_l2 / tv_ut_l2 / 2.0
            greg = torch.where(
                live, reg + lambd * gradu + (u - ut) / 4.0, lambd * gradu + (u - ut) / 2.0
            )
        else:
            greg = lambd * gradu + (u - ut) / 2.0
        # 6. per-channel step over the whole padded window
        dt = sf * (torch.amax(u, dim=(1, 2)) + inv_un) / (
            torch.amax(torch.abs(greg), dim=(1, 2)) + 1e-15
        )
        u = u - dt[:, None, None] * greg
        # 7. TV-denoise the observed image (use_tv only)
        if tv is not None:
            denoise = torch.where(live, reg, 0.0)
            dt_img = sf * (torch.amax(image, dim=(1, 2)) + 1.0 / (m * n)) / (
                torch.amax(torch.abs(denoise), dim=(1, 2)) + 1e-15
            )
            image = image - dt_img[:, None, None] * denoise[:, pad : pad + m, pad : pad + n] / lambd
        # 8. keep the blurry image where deblurring failed (inner crop only)
        crop = u[:, pad : pad + m, pad : pad + n]
        u[:, pad : pad + m, pad : pad + n] = (1.0 - dof) * crop + dof * image
        if blind:
            # 9. PSF refinement from the post-update residual
            error = conv(u, psf, "valid") - image
            gradk = psf_grad(u, error)
            dtpsf = sf / mk * (torch.amax(psf) + 1.0 / (u_m * u_n * 3)) / (
                torch.amax(torch.abs(gradk)) + 1e-15
            )
            psf = psf - dtpsf * gradk
            if correlation:
                psf = torch.mean(psf, dim=0, keepdim=True).expand(c, mk, mk)
            psf = torch.clamp(psf, min=0.0)
            psf = (psf / torch.sum(psf, dim=(1, 2), keepdim=True)).contiguous()
            psf_rot = torch.flip(psf, dims=(1, 2)).contiguous()
        if mixed:
            delta = u - u_start
    return u, psf, error, image


def inner_loop_plain(u, image, psf, *, step_factor, lambd, blind, correlation):
    """Plain PyTorch twin of K2: the parity-mode op loop on the plain
    convolution and PSF-gradient twins.  Returns (u', psf', error)."""
    u, psf, error, _ = inner_loop_ops(
        u, image, psf, step_factor=step_factor, lambd=lambd, blind=blind,
        correlation=correlation, conv=conv_planar_plain,
        psf_grad=psf_gradient_plain,
    )
    return u, psf, error


@functools.lru_cache(maxsize=None)
def _grid_blocks(device_index: int, mk: int) -> int:
    import ctypes

    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _build.check(
            _build.load_library().ics_inner_loop_blocks(ctypes.byref(n), mk),
            "ics_inner_loop_blocks",
        )
    return n.value


def inner_loop_planar(u, image, psf, *, step_factor, lambd, blind, correlation):
    """One outer iteration's inner loop: K2 on CUDA tensors, the plain twin
    on CPU ones.  Returns (u', psf', error).

    On CUDA, ``u`` is updated in place and returned (the TPU kernel aliases
    it the same way); the twin returns a new tensor.
    """
    global launches
    if u.device.type == "cpu":
        return inner_loop_plain(
            u, image, psf, step_factor=step_factor, lambd=lambd, blind=blind,
            correlation=correlation,
        )
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    tensors = (u, image, psf)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("K2 takes float32 only")
    if any(t.device != u.device for t in tensors):
        raise ValueError("u, image and psf must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K2 needs contiguous planar u, image and psf")
    c, u_m, u_n = u.shape
    _, m, n = image.shape
    mk = psf.shape[1]
    if (
        c != 3 or image.shape[0] != 3 or psf.shape != (3, mk, mk)
        or mk > MAX_TAPS_SIDE or u_m - m + 1 != mk or u_n - n + 1 != mk
    ):
        raise ValueError(
            f"K2 takes u (3, M+mk-1, N+mk-1), image (3, M, N) and psf "
            f"(3, mk, mk) with mk <= {MAX_TAPS_SIDE}; got {tuple(u.shape)}, "
            f"{tuple(image.shape)}, {tuple(psf.shape)}"
        )
    n_blocks = _grid_blocks(u.device.index or 0, mk)
    dev = u.device
    psf_out = torch.empty_like(psf)
    err = torch.empty_like(image)
    ut = torch.empty_like(u)
    greg = torch.empty_like(u)
    dof = torch.empty_like(image)
    partial = torch.empty(n_blocks * (2 * c + c * mk * mk), dtype=torch.float32, device=dev)
    rc = _build.load_library().ics_inner_loop(
        u.data_ptr(), image.data_ptr(), psf.data_ptr(), psf_out.data_ptr(),
        err.data_ptr(), ut.data_ptr(), greg.data_ptr(), dof.data_ptr(),
        partial.data_ptr(), c, u_m, u_n, m, n, mk,
        float(np.float32(step_factor)), float(np.float32(lambd)),
        float(np.float32(1.0 / (u_m * u_n))),
        float(np.float32(1.0 / (u_m * u_n * 3))),
        int(bool(blind)), int(bool(correlation)), n_blocks,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "ics_inner_loop")
    launches += 1
    return u, psf_out, err
