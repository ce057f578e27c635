"""sRGB <-> CIELAB conversions (counterpart of ics_tpu/utils/color.py:40-101
and its ``LABImage``), as torch functions on the input's device.

The 3x3 colour matrices are float32 ``einsum``s with TF32 off, as the JAX
package computes them in float32.  The rest of ics_tpu/utils/color.py (HSV,
``grey_point``, ``auto_vibrance``, ``divTV``, ``gradTVEM``, the Lagrange
path) is not ported yet (ROADMAP item 10).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ics_tpu_torch._device import exact_f32

__all__ = ["LABImage", "rgb_to_lab", "lab_to_rgb"]

# D65 white point, sRGB primaries (IEC 61966-2-1)
_XYZ_FROM_RGB = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ]
)
_RGB_FROM_XYZ = np.linalg.inv(_XYZ_FROM_RGB)
_WHITE_D65 = np.array([0.95047, 1.0, 1.08883])


@dataclasses.dataclass
class LABImage:
    """LAB container with the attribute surface the reference's colour ops
    expect (``src.L``, ``src.A``, ``src.B``)."""

    L: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor


def _const(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def _srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c):
    return torch.where(
        c <= 0.0031308, c * 12.92, 1.055 * torch.clamp(c, min=1e-12) ** (1 / 2.4) - 0.055
    )


def _lab_f(t):
    d = 6.0 / 29.0
    # cube root of the branch that is taken (t > d^3 > 0)
    return torch.where(t > d**3, torch.clamp(t, min=d**3) ** (1.0 / 3.0),
                       t / (3 * d * d) + 4.0 / 29.0)


def _lab_f_inv(t):
    d = 6.0 / 29.0
    return torch.where(t > d, t**3, 3 * d * d * (t - 4.0 / 29.0))


def rgb_to_lab(rgb: torch.Tensor) -> LABImage:
    """sRGB [0,1] (..., 3) float32 tensor -> CIELAB (L in [0,100])."""
    exact_f32()
    lin = _srgb_to_linear(rgb)
    xyz = torch.einsum("ij,...j->...i", _const(_XYZ_FROM_RGB, lin), lin)
    xyz = xyz / _const(_WHITE_D65, lin)
    f = _lab_f(xyz)
    l = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return LABImage(L=l, A=a, B=b)


def lab_to_rgb(lab: LABImage) -> torch.Tensor:
    """CIELAB -> sRGB [0,1] (..., 3), clipped to gamut."""
    exact_f32()
    l, a, b = lab.L, lab.A, lab.B
    fy = (l + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    xyz = torch.stack([_lab_f_inv(fx), _lab_f_inv(fy), _lab_f_inv(fz)], dim=-1)
    xyz = xyz * _const(_WHITE_D65, xyz)
    lin = torch.einsum("ij,...j->...i", _const(_RGB_FROM_XYZ, xyz), xyz)
    return torch.clamp(_linear_to_srgb(lin), 0.0, 1.0)
