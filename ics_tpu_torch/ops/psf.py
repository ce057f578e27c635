"""PSF utilities (counterpart of ics_tpu/ops/psf.py).

``normalize_kernel`` clamps negative taps to zero and makes each channel sum
to 1 (ref lib/deconvolution.pyx:47-75); ``rotate_180`` flips both spatial
axes.  Both take the JAX package's (MK, MK) or (MK, MK, C) layout;
``normalize_kernel_np`` is the host-side NumPy variant, copied from
ics_tpu/ops/psf.py:32-37 (the port never imports ``ics_tpu``);
``project_planar`` is the solvers' PSF projection on planar (C, MK, MK).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["normalize_kernel", "normalize_kernel_np", "rotate_180", "project_planar"]


def normalize_kernel(kern: torch.Tensor, mk: int | None = None) -> torch.Tensor:
    """Clamp negative taps to 0 and normalize each channel to sum 1.

    ``mk`` is accepted for signature parity with the reference and ignored.
    Functional: returns a new tensor.
    """
    kern = torch.clamp(kern, min=0.0)
    if kern.ndim == 2:
        return kern / torch.sum(kern)
    return kern / torch.sum(kern, dim=(0, 1), keepdim=True)


def normalize_kernel_np(kern: np.ndarray) -> np.ndarray:
    """Host-side (NumPy) variant for pipeline setup code."""
    kern = np.maximum(kern, 0.0)
    if kern.ndim == 2:
        return kern / kern.sum()
    return kern / kern.sum(axis=(0, 1), keepdims=True)


def rotate_180(array: torch.Tensor) -> torch.Tensor:
    """Rotate (H, W) or (H, W, C) by 180° about the spatial center."""
    return torch.flip(array, dims=(0, 1))


def project_planar(psf: torch.Tensor, correlation: bool = False, lanes: int = 1) -> torch.Tensor:
    """A blind step's planar (C, MK, MK) PSF onto the simplex: the channel
    mean first when ``correlation`` (one PSF for every channel), then
    ``normalize_kernel``'s clamp and per-channel rescale; contiguous.
    ``lanes``: the channels hold that many images' PSFs, each meaned on
    its own."""
    if correlation:
        per = psf.reshape(lanes, -1, *psf.shape[1:])
        psf = torch.mean(per, dim=1, keepdim=True).expand_as(per).reshape(psf.shape)
    psf = torch.clamp(psf, min=0.0)
    return (psf / torch.sum(psf, dim=(1, 2), keepdim=True)).contiguous()
