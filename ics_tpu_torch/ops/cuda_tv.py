"""K5: the TV stencil kernel (csrc/tv.cu) and its plain twin.

Counterpart of ics_tpu/ops/pallas_tv.py, whose math is
ics_tpu/ops/tv.py::tv_op.  Planar (C, H, W) float32 or bfloat16 input;
returns ``(tv, div)`` of the input's shape and dtype with the border ring at
zero.  bfloat16 input is computed in f32 and rounded once, where the JAX
stencil rounds every bf16 op.  On CPU tensors the wrapper runs the plain
twin; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ics_tpu_torch import _build

__all__ = ["tv_planar", "tv_planar_plain"]

_SQRT2 = math.sqrt(2.0)
launches = 0  # kernel launches by tv_planar (the twin never counts)


def _check(u: torch.Tensor, order: int, norm: int) -> None:
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    if norm not in (1, 2):
        raise ValueError("norm must be 1 (L1) or 2 (L2)")
    if u.ndim != 3 or u.shape[1] < 3 or u.shape[2] < 3:
        raise ValueError(f"expected u (C, H, W) with H, W >= 3, got {tuple(u.shape)}")
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"float32 or bfloat16 only, got {u.dtype}")


def _adjust(norm: int) -> float:
    return 4.0 * (1.0 + 1.0 / _SQRT2) if norm == 1 else 2.0 * (1.0 + _SQRT2)


def tv_planar_plain(u: torch.Tensor, epsilon: float, order: int = 2, norm: int = 1):
    """Plain twin of K5: a transcription of ``tv_op`` on planar input.

    The divisors are device tensors, not Python scalars: PyTorch's CUDA
    division by a CPU scalar multiplies by its reciprocal, which is not
    ``tv_op``'s (or K5's) rounding."""
    _check(u, order, norm)
    x = u.float()
    sqrt2 = torch.tensor(_SQRT2, dtype=torch.float32, device=u.device)
    adjust = torch.tensor(_adjust(norm), dtype=torch.float32, device=u.device)
    h, w = x.shape[1], x.shape[2]

    def sh(di, dj):  # u[i + di, j + dj] on the interior
        return x[:, 1 + di : h - 1 + di, 1 + dj : w - 1 + dj]

    if norm == 1:
        nrm = lambda a, b: torch.abs(a) + torch.abs(b) + epsilon
    else:
        nrm = lambda a, b: torch.sqrt(a * a + b * b + epsilon * epsilon)

    c = sh(0, 0)
    if order == 2:
        udx = -2.0 * c + sh(-1, 0) + sh(1, 0)
        udy = -2.0 * c + sh(0, -1) + sh(0, 1)
        udxdy = (-2.0 * c + sh(-1, -1) + sh(1, 1)) / sqrt2
        udydx = (-2.0 * c + sh(-1, 1) + sh(1, -1)) / sqrt2
        div = (-udx - udy - udxdy - udydx) / adjust
        tv = (nrm(udx, udy) + nrm(udxdy, udydx)) / adjust
    else:
        udx_b = c - sh(-1, 0)
        udy_b = c - sh(0, -1)
        udx_f = -c + sh(1, 0)
        udy_f = -c + sh(0, 1)
        udxdy_b = (c - sh(-1, -1)) / sqrt2
        udydx_b = (c - sh(-1, 1)) / sqrt2
        udydx_f = (-c + sh(1, -1)) / sqrt2
        udxdy_f = (-c + sh(1, 1)) / sqrt2
        div = (udx_b + udy_b - udx_f - udy_f + udxdy_b + udydx_b - udxdy_f
               - udydx_f) / adjust
        tv = (nrm(udx_b, udy_b) + nrm(udx_f, udy_f) + nrm(udxdy_b, udydx_b)
              + nrm(udxdy_f, udydx_f)) / adjust
    return (F.pad(tv, (1, 1, 1, 1)).to(u.dtype), F.pad(div, (1, 1, 1, 1)).to(u.dtype))


def tv_planar(u: torch.Tensor, epsilon: float, order: int = 2, norm: int = 1):
    """``(tv, div)`` of planar u: K5 on CUDA tensors, the plain twin on CPU
    ones."""
    global launches
    if u.device.type == "cpu":
        return tv_planar_plain(u, epsilon, order, norm)
    _check(u, order, norm)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    if not u.is_contiguous():
        raise ValueError("K5 needs contiguous u")
    c, h, w = u.shape
    tv = torch.empty_like(u)
    div = torch.empty_like(u)
    f32 = lambda v: float(np.float32(v))
    rc = _build.load_library().ics_tv(
        u.data_ptr(), tv.data_ptr(), div.data_ptr(), c, h, w, int(order), int(norm),
        f32(epsilon), f32(epsilon * epsilon), f32(_SQRT2), f32(_adjust(norm)),
        int(u.dtype == torch.bfloat16), torch.cuda.current_stream(u.device).cuda_stream,
    )
    _build.check(rc, "ics_tv")
    launches += 1
    return tv, div
