"""Whole-tensor scalar reductions and the residual-whiteness weight window
(counterpart of ics_tpu/ops/reductions.py).

The reductions are the reference's nogil mean / variance / amax / amax-abs /
L1 / L2 norms over flat float buffers (lib/deconvolution.pyx:255-338), each
one 0-d tensor on its input's own device.  ``whiteness_weights`` is
host-side NumPy, copied from ics_tpu/ops/reductions.py:53-65: the port never
imports ``ics_tpu``, whose package import loads JAX.  The solver's
variances use ``correction=0`` (ddof 0, as ``jnp.std``); ``torch.std``
defaults to 1.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "mean",
    "variance",
    "amax",
    "amaxabs",
    "array_norm_L1",
    "array_norm_L2",
    "whiteness_weights",
]


def mean(a: torch.Tensor) -> torch.Tensor:
    return torch.mean(a)


def variance(a: torch.Tensor, m: torch.Tensor | None = None) -> torch.Tensor:
    if m is None:
        m = torch.mean(a)
    return torch.mean((m - a) ** 2)


def amax(a: torch.Tensor) -> torch.Tensor:
    return torch.amax(a)


def amaxabs(a: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(a))


def array_norm_L2(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(a * a))


def array_norm_L1(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(a))


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
