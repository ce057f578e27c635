"""K6: the bilateral filter kernel (csrc/bilateral.cu) and its plain twin.

Counterpart of ics_tpu/ops/pallas_bilateral.py, whose math is
ics_tpu/utils/filters.py::bilateral_filter.  Planar (C, H, W) float32 input,
each plane filtered on its own after symmetric padding by ``radius``;
returns (C, H, W) float32.  On CPU tensors the wrapper runs the plain twin;
on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ics_tpu_torch import _build
from ics_tpu_torch.ops.conv import pad_symmetric

__all__ = ["bilateral_planar", "bilateral_planar_plain", "MAX_RADIUS"]

MAX_RADIUS = 32  # csrc/bilateral.cu kMaxRadius: the shared-memory tile
launches = 0  # kernel launches by bilateral_planar (the twin never counts)

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _constants(std_i: float, std_s: float) -> tuple[float, float, float, float]:
    """(inv2si2, norm_i, inv2ss2, norm_s): computed in double and rounded
    once to float32, as ics_tpu/ops/pallas_bilateral.py:59-66 does."""
    f32 = lambda v: float(np.float32(v))
    return (f32(1.0 / (2.0 * std_i * std_i)), f32(_INV_SQRT_2PI / std_i),
            f32(1.0 / (2.0 * std_s * std_s)), f32(_INV_SQRT_2PI / std_s))


def _kernel_constants(std_i: float, std_s: float) -> tuple[float, float]:
    """(s, a) of csrc/bilateral.cu, whose weight is
    exp2(-((nb*s - c*s)^2 + a*(dy^2 + dx^2))): the base-2 exponents
    s = sqrt(inv2si2 * log2 e) and a = inv2ss2 * log2 e, in double and
    rounded once.  norm_i * norm_s cancels in num / den."""
    log2e = 1.0 / math.log(2.0)
    return (float(np.float32(math.sqrt(log2e / (2.0 * std_i * std_i)))),
            float(np.float32(log2e / (2.0 * std_s * std_s))))


def _check(src: torch.Tensor, radius) -> int:
    if src.ndim != 3:
        raise ValueError(f"expected src (C, H, W), got {tuple(src.shape)}")
    if src.dtype != torch.float32:
        raise TypeError(f"float32 only, got {src.dtype}")
    if radius != int(radius) or radius < 0:
        raise ValueError(f"radius must be a non-negative integer, got {radius!r}")
    return int(radius)


def bilateral_planar_plain(src: torch.Tensor, radius: int, std_i: float,
                           std_s: float) -> torch.Tensor:
    """Plain twin of K6, in the TPU kernel's form: host-rounded reciprocals,
    offset rows outer and columns inner, one shifted pass per offset."""
    radius = _check(src, radius)
    inv2si2, norm_i, inv2ss2, norm_s = _constants(std_i, std_s)
    _, h, w = src.shape
    padded = pad_symmetric(src, (radius, radius), (radius, radius))
    num = torch.zeros_like(src)
    den = torch.zeros_like(src)
    for dy in range(2 * radius + 1):
        for dx in range(2 * radius + 1):
            d2 = np.float32((dy - radius) ** 2 + (dx - radius) ** 2)
            gs = float(np.exp(-d2 * np.float32(inv2ss2)) * np.float32(norm_s))
            nb = padded[:, dy : dy + h, dx : dx + w]
            diff = nb - src
            wgt = torch.exp(-(diff * diff) * inv2si2) * norm_i * gs
            num = num + nb * wgt
            den = den + wgt
    return num / den


def bilateral_planar(src: torch.Tensor, radius: int, std_i: float,
                     std_s: float) -> torch.Tensor:
    """Bilateral filter of each plane of ``src``: K6 on CUDA tensors (radius
    up to ``MAX_RADIUS``), the plain twin on CPU ones."""
    global launches
    if src.device.type == "cpu":
        return bilateral_planar_plain(src, radius, std_i, std_s)
    radius = _check(src, radius)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    if radius > MAX_RADIUS:
        raise ValueError(f"K6 takes a radius up to {MAX_RADIUS}, got {radius}")
    if not src.is_contiguous():
        raise ValueError("K6 needs a contiguous src")
    c, h, w = src.shape
    out = torch.empty_like(src)
    rc = _build.load_library().ics_bilateral(
        src.data_ptr(), out.data_ptr(), c, h, w, radius, *_kernel_constants(std_i, std_s),
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    _build.check(rc, "ics_bilateral")
    launches += 1
    return out
