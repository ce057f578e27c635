"""PSF seed windows (host-side NumPy).

Copied from ics_tpu/ops/windows.py:25-45: the port never imports
``ics_tpu``, whose package import loads JAX.
"""

from __future__ import annotations

import numpy as np

__all__ = ["uniform_kernel", "gaussian_kernel"]


def uniform_kernel(size: int) -> np.ndarray:
    """size×size kernel of equal weights summing to 1 (ref lib/utils.py:146)."""
    kern = np.ones((size, size), dtype=np.float64)
    kern /= kern.sum()
    return kern


def _gaussian_window(m: int, std: float) -> np.ndarray:
    # scipy.signal.windows.gaussian: w[n] = exp(-0.5 ((n - (M-1)/2) / std)^2)
    n = np.arange(m, dtype=np.float64) - (m - 1) / 2.0
    return np.exp(-0.5 * (n / std) ** 2)


def gaussian_kernel(radius: int, std: float) -> np.ndarray:
    """Normalized outer product of Gaussian windows (ref lib/utils.py:152)."""
    window = _gaussian_window(radius, std)
    kern = np.outer(window, window)
    return kern / kern.sum()
