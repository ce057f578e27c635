"""The banded resize kernel (csrc/resize.cu) and its plain twin: one axis of
``utils/resize.py::resize_jax``.

Replaces no TPU kernel: the JAX package resizes with ``jax.image.resize``
(ics_tpu/utils/resize.py:51-70), dense weight matrices applied by XLA.  On
a CPU tensor the wrapper runs the plain twin, that dense product
(``weight_matrix``, float32, TF32 off); on a CUDA tensor it launches the
kernel, which reads only each output's band of taps (``band_tables``,
uploaded once per shape, method and device), or raises.  No dense matrix is
built on the card.
"""

from __future__ import annotations

import functools
import math

import torch

from ics_tpu_torch import _build
from ics_tpu_torch._device import exact_f32
from ics_tpu_torch.utils.resize import band_tables, weight_matrix

__all__ = ["resample", "resample_plain"]

launches = 0  # kernel launches by resample (the twin never counts)


def _check(x: torch.Tensor, axis: int, out_size: int) -> None:
    if x.ndim < 2 or axis not in (0, 1):
        raise ValueError(f"expected (H, W, ...) and axis 0 or 1, got {tuple(x.shape)} and {axis}")
    if x.dtype != torch.float32:
        raise TypeError(f"float32 only, got {x.dtype}")
    if out_size < 1 or x.shape[axis] < 1:
        raise ValueError(f"cannot resize an axis of {x.shape[axis]} to {out_size}")


def resample_plain(x: torch.Tensor, axis: int, out_size: int,
                   method: str = "cubic") -> torch.Tensor:
    """Plain twin: axis 0 or 1 of (H, W, ...) resized by the dense
    ``weight_matrix`` product, on ``x``'s device."""
    _check(x, axis, out_size)
    exact_f32()
    w = weight_matrix(x.shape[axis], out_size, str(x.device), method)
    if axis == 0:
        return (w.T @ x.reshape(x.shape[0], -1)).reshape(out_size, *x.shape[1:])
    return (x.movedim(1, -1) @ w).movedim(-1, 1).contiguous()


@functools.lru_cache(maxsize=64)
def _device_tables(in_size: int, out_size: int, method: str, device: torch.device):
    return tuple(t.to(device) for t in band_tables(in_size, out_size, method))


def resample(x: torch.Tensor, axis: int, out_size: int, method: str = "cubic") -> torch.Tensor:
    """The banded kernel on a contiguous float32 CUDA tensor, the plain twin
    on a CPU one: axis 0 or 1 of (H, W, ...) resized to ``out_size``."""
    global launches
    if x.device.type == "cpu":
        return resample_plain(x, axis, out_size, method)
    _check(x, axis, out_size)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("the resize kernel needs a contiguous input")
    shape = list(x.shape)
    n_in = shape[axis]
    outer, inner = math.prod(shape[:axis]), math.prod(shape[axis + 1:])
    if max(outer, n_in, out_size, inner) >= 2**31:
        raise ValueError(f"the resize kernel takes sizes below 2**31: {shape}")
    start, count, weights = _device_tables(n_in, out_size, method, x.device)
    shape[axis] = out_size
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    rc = lib.ics_resample(
        x.data_ptr(), out.data_ptr(), start.data_ptr(), count.data_ptr(), weights.data_ptr(),
        outer, n_in, out_size, inner, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "ics_resample")
    launches += 1
    return out
