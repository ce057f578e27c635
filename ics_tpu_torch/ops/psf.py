"""PSF utilities (counterpart of ics_tpu/ops/psf.py).

``normalize_kernel`` clamps negative taps to zero and makes each channel sum
to 1 (ref lib/deconvolution.pyx:47-75); ``rotate_180`` flips both spatial
axes.  Both take the JAX package's (MK, MK) or (MK, MK, C) layout.
"""

from __future__ import annotations

import torch

__all__ = ["normalize_kernel", "rotate_180"]


def normalize_kernel(kern: torch.Tensor, mk: int | None = None) -> torch.Tensor:
    """Clamp negative taps to 0 and normalize each channel to sum 1.

    ``mk`` is accepted for signature parity with the reference and ignored.
    Functional: returns a new tensor.
    """
    kern = torch.clamp(kern, min=0.0)
    if kern.ndim == 2:
        return kern / torch.sum(kern)
    return kern / torch.sum(kern, dim=(0, 1), keepdim=True)


def rotate_180(array: torch.Tensor) -> torch.Tensor:
    """Rotate (H, W) or (H, W, C) by 180° about the spatial center."""
    return torch.flip(array, dims=(0, 1))
