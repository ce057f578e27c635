"""ε-regularized total-variation magnitude and divergence over the
8-neighbour stencil (counterpart of ics_tpu/ops/tv.py; ref
lib/deconvolution.pyx:137-239), and the collaborative channel couplings.

Every stencil runs through ``ops/cuda_tv.py``: K5 on CUDA tensors, its plain
twin (a transcription of the JAX ``tv_op``) on CPU tensors, called through
the module's attribute, so that a wrapper set on ``cuda_tv.tv_planar`` sees
every call.  The public functions take the JAX package's (H, W, C) or (H, W)
layout; the solver calls the planar ``tv_auto_planar``.
"""

from __future__ import annotations

import torch

from ics_tpu_torch.ops import cuda_tv

__all__ = ["tv_op", "tv_op_auto", "tv_auto_planar", "collab_sup", "collab_l2"]

_METHODS = ("auto", "xla", "pallas")
_COLLAB = (False, True, "sup", "l2")


def _couple(tv: torch.Tensor, collab: bool | str, dim: int) -> torch.Tensor:
    """The channel coupling over axis ``dim``: RMS for 'l2', else the max."""
    if collab == "l2":
        return torch.sqrt(torch.mean(tv * tv, dim=dim, keepdim=True))
    return torch.amax(tv, dim=dim, keepdim=True)


def collab_sup(tv: torch.Tensor) -> torch.Tensor:
    """Collaborative L^{∞,1,1} coupling: the per-pixel channel maximum of an
    (H, W, C) magnitude, shape (H, W, 1) (ics_tpu/ops/tv.py:29-50)."""
    return _couple(tv, "sup", 2)


def collab_l2(tv: torch.Tensor) -> torch.Tensor:
    """ℓ²-over-color coupling: the per-pixel channel RMS of an (H, W, C)
    magnitude, shape (H, W, 1) (ics_tpu/ops/tv.py:53-71)."""
    return _couple(tv, "l2", 2)


def _hwc_call(u: torch.Tensor, fn):
    planar = u.unsqueeze(0) if u.ndim == 2 else u.permute(2, 0, 1)
    tv, div = fn(planar.contiguous())
    if u.ndim == 2:
        return tv[0], div[0]
    return tv.permute(1, 2, 0), div.permute(1, 2, 0)


def tv_op(u: torch.Tensor, epsilon: float, order: int = 2, norm: int = 1):
    """``(tv, div)`` with zero borders, both shaped like ``u`` (H, W[, C])."""
    return _hwc_call(u, lambda p: cuda_tv.tv_planar(p, epsilon, order, norm))


def tv_auto_planar(u: torch.Tensor, epsilon: float, order: int = 2, norm: int = 1,
                   method: str = "auto", collab: bool | str = False):
    """``tv_op_auto`` on planar (C, H, W) input: the coupled magnitude is
    (1, H, W), the divergence stays per channel."""
    if method not in _METHODS:
        raise ValueError(f"unknown tv method {method!r}")
    if collab not in _COLLAB:
        raise ValueError(f"unknown collab coupling {collab!r}")
    tv, div = cuda_tv.tv_planar(u, epsilon, order, norm)
    if collab and u.shape[0] > 1:
        tv = _couple(tv, collab, 0)
    return tv, div


def tv_op_auto(u: torch.Tensor, epsilon: float, order: int = 2, norm: int = 1,
               method: str = "auto", collab: bool | str = False):
    """``tv_op`` with the JAX backend switch (ics_tpu/ops/tv.py:74-122).

    ``method`` 'auto' | 'xla' | 'pallas' is accepted for API parity: every
    value runs K5 on CUDA tensors (the JAX package's 'auto' picks its XLA
    stencil there) and the plain twin on CPU ones.  ``collab`` True or
    'sup' returns :func:`collab_sup` of the magnitude, 'l2'
    :func:`collab_l2`; the coupling is applied outside the stencil, as in
    JAX."""
    return _hwc_call(u, lambda p: tv_auto_planar(p, epsilon, order, norm, method, collab))
