"""2D convolution-window (PSF seed) generators (host-side NumPy).

Copied from ics_tpu/ops/windows.py: the port never imports ``ics_tpu``,
whose package import loads JAX.  Behavioral parity targets: reference
lib/utils.py:134-170 (uniform, gaussian, kaiser, poisson/exponential, disc
"lens blur" kernels — each a normalized outer product of a 1-D window).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "uniform_kernel",
    "gaussian_kernel",
    "kaiser_kernel",
    "poisson_kernel",
    "disc_blur",
    "lens_blur",
    "motion_kernel",
    "gaussian_weight",
]


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


def kaiser_kernel(radius: int, beta: float) -> np.ndarray:
    """Normalized outer product of Kaiser-Bessel windows (ref lib/utils.py:159)."""
    window = np.kaiser(radius, beta)
    kern = np.outer(window, window)
    return kern / kern.sum()


def _exponential_window(m: int, tau: float) -> np.ndarray:
    # scipy.signal.windows.exponential (symmetric): w[n] = exp(-|n - (M-1)/2| / tau)
    n = np.arange(m, dtype=np.float64)
    center = (m - 1) / 2.0
    return np.exp(-np.abs(n - center) / tau)


def poisson_kernel(radius: int, tau: float) -> np.ndarray:
    """Normalized outer product of exponential windows (ref lib/utils.py:166)."""
    window = _exponential_window(radius, tau)
    kern = np.outer(window, window)
    return kern / kern.sum()


def disc_blur(x: float) -> list:
    """Half disc-blur 1-D profile 1/(pi k^2), k = 1..x/2 (ref lib/utils.py:134)."""
    return [1.0 / (np.pi * k**2) for k in range(1, int(x / 2) + 1)]


def lens_blur(size: float) -> np.ndarray:
    """Normalized outer product of the disc profile (ref lib/utils.py:139)."""
    window = disc_blur(size)
    kern = np.outer(window, window)
    return kern / kern.sum()


def motion_kernel(size: int, angle_deg: float = 0.0) -> np.ndarray:
    """Linear-motion PSF: an anti-aliased line segment through the kernel
    center at ``angle_deg``, normalized to sum 1.

    The reference names a motion-blur mode (``blur="motion"`` →
    ``correlation=True``, ref deconvolve.py:154-157; the solver then forces
    the refined PSF achromatic, ref lib/deconvolution.pyx:584-585) but ships
    no generator for the PSF class that mode targets; this is that
    generator, used by the blind-restoration success battery's motion
    cases (``utils.selftest.make_success_battery``).

    Anti-aliasing is bilinear splatting of a supersampled segment — the
    standard rasterization, so 0°/90° reduce to an exact 1-pixel line.
    """
    if size < 3 or size % 2 == 0:
        raise ValueError("motion kernel size must be odd and >= 3")
    c = (size - 1) / 2.0
    theta = np.deg2rad(angle_deg)
    dx, dy = np.cos(theta), np.sin(theta)
    kern = np.zeros((size, size), dtype=np.float64)
    # dense samples along the segment; bilinear splat each one
    for t in np.linspace(-c, c, 16 * size):
        y, x = c + t * dy, c + t * dx
        y0, x0 = int(np.floor(y)), int(np.floor(x))
        fy, fx = y - y0, x - x0
        for oy, wy in ((0, 1.0 - fy), (1, fy)):
            for ox, wx in ((0, 1.0 - fx), (1, fx)):
                yy, xx = y0 + oy, x0 + ox
                if 0 <= yy < size and 0 <= xx < size:
                    kern[yy, xx] += wy * wx
    return kern / kern.sum()


def gaussian_weight(source, target: float, sigma: float):
    """Normal pdf of `source` around `target` (ref lib/deconvolution.pyx:35).

    Also fixes the reference's latent defect where ``bilateral_filter`` calls
    an undefined ``gaussian(...)`` (ref lib/utils.py:186): this is the weight
    function it needs.
    """
    return np.exp(-((source - target) ** 2) / (2.0 * sigma**2)) / (
        sigma * np.sqrt(2.0 * np.pi)
    )
