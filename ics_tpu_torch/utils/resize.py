"""Cubic resize, the same function as ``jax.image.resize(..., "cubic")``
(counterpart of ``resize_jax`` in ics_tpu/utils/resize.py:51-70).

JAX resizes by one dense weight matrix per axis whose size changes, built by
``jax._src.image.scale.compute_weight_mat``: the Keys cubic (a = -0.5) at
half-pixel centers; on downscale the kernel is widened by 1/scale
(antialiasing); each output's weights are renormalized to sum 1 (which drops
the taps that fall outside the input); outputs whose sample point lies
outside the input get weight 0.  The matrices are built here the same way,
with the same float32 sample positions, on the image's device (a 24 MP level's
matrix holds 25 M entries), cached per shape, and applied as float32 matmuls
with TF32 off.  ``F.interpolate(mode="bicubic")`` uses another coefficient,
edge rule and no antialiasing: it is not this function.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ics_tpu_torch._device import exact_f32

__all__ = ["resize_jax", "weight_matrix"]


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


@functools.lru_cache(maxsize=32)
def weight_matrix(in_size: int, out_size: int, device: str = "cpu") -> torch.Tensor:
    """(in_size, out_size) float32 weights of one resized axis."""
    f32 = torch.float32
    # JAX: scale = out/in and inv_scale = 1/scale in double (Python floats),
    # rounded to float32 where they meet float32 arrays
    inv_scale = float(np.float32(1.0 / (out_size / in_size)))
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(
        sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]
    ) / kernel_scale
    # the cubic and its renormalization in float64, rounded once: JAX's float32
    # rounding of them depends on the backend's FMA contraction, and float64
    # lands within a few 1e-7 of each backend's result
    weights = _keys_cubic(x.double())
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(f32)


def resize_jax(image: torch.Tensor, shape) -> torch.Tensor:
    """Resize (H, W, ...) to ``shape[:2]`` spatially, on the tensor's device.

    Axes whose size does not change are left as they are (JAX skips them
    too), so a same-size call returns ``image`` itself.
    """
    exact_f32()
    out_h, out_w = int(shape[0]), int(shape[1])
    in_h, in_w = image.shape[0], image.shape[1]
    dev = str(image.device)
    out = image.to(torch.float32)
    if in_h != out_h:
        wh = weight_matrix(in_h, out_h, dev)
        rest = out.shape[1:]
        out = (wh.T @ out.reshape(in_h, -1)).reshape(out_h, *rest)
    if in_w != out_w:
        ww = weight_matrix(in_w, out_w, dev)
        out = (out.movedim(1, -1) @ ww).movedim(-1, 1).contiguous()
    return out
