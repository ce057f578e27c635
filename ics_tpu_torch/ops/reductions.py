"""Residual-whiteness weight window (host-side NumPy).

Copied from ics_tpu/ops/reductions.py:53-65: the port never imports
``ics_tpu``, whose package import loads JAX.  The solver's variances use
``correction=0`` (ddof 0, as ``jnp.std``); ``torch.std`` defaults to 1.
"""

from __future__ import annotations

import numpy as np

__all__ = ["whiteness_weights"]


def whiteness_weights(height: int, width: int) -> np.ndarray:
    """Gaussian-tapered weight window of the residual-whiteness metric.

    Reproduces ref lib/deconvolution.pyx:392-404: take linspace(-1, 1) along
    each side, map through the N(0, 1) pdf, form sqrt(outer(...)), normalize
    to sum 1.
    """
    h = np.linspace(-1.0, 1.0, num=height, dtype=np.float64)
    w = np.linspace(-1.0, 1.0, num=width, dtype=np.float64)
    pdf = lambda x: np.exp(-(x**2) / 2.0) / np.sqrt(2.0 * np.pi)
    weights = np.sqrt(np.outer(pdf(h), pdf(w)))
    weights /= weights.sum()
    return weights.astype(np.float32)
