"""Total-Variation denoising, Chambolle's dual projection algorithm
(counterpart of ics_tpu/models/tv_denoise.py).

    min_u  ||u - f||^2 / (2*weight) + TV(u)

solved in the dual: p_{t+1} = (p + tau grad(div p - f/weight)) /
(1 + tau |grad(...)|), u = f - weight * div(p).  Elementwise torch on the
input's device, no kernel of its own.  JAX runs the iterations as one
``lax.fori_loop`` (ics_tpu/models/tv_denoise.py:60); here each iteration
writes the dual field in place, at fixed addresses, and the iterations go
through the solvers' outer loop (``rl_mm._solve_outers``) with K7 as the
counter (``use_stopping=False``): on CUDA iteration 1 runs eagerly and the
rest in one launch of a WHILE graph, with no host read before the result.
Where ``rl_mm._eager_loop()`` holds (inside ``rl_mm._eager_outer_loop()``, or
under torch's profiler) the host loop launches the same body iteration by
iteration.
"""

from __future__ import annotations

import torch

from ics_tpu_torch._device import resolve_device, to_f32
from ics_tpu_torch.models import rl_mm

__all__ = ["tv_denoise"]


def _grad(u):
    """Forward differences with replicated edge (zero at the far border)."""
    dy = torch.cat([u[1:] - u[:-1], torch.zeros_like(u[:1])], dim=0)
    dx = torch.cat([u[:, 1:] - u[:, :-1], torch.zeros_like(u[:, :1])], dim=1)
    return dy, dx


def _div(py, px):
    """Adjoint of -_grad: backward differences with boundary handling."""
    dy = torch.cat([py[:1], py[1:-1] - py[:-2], -py[-2:-1]], dim=0)
    dx = torch.cat([px[:, :1], px[:, 1:-1] - px[:, :-2], -px[:, -2:-1]], dim=1)
    return dy + dx


def tv_denoise(image, weight: float = 0.1, iterations: int = 50,
               device="cuda") -> torch.Tensor:
    """Denoise (H, W) or (H, W, C) images; each channel's dual field is
    independent (skimage's channel-wise default).  Returns float32 on
    ``device``."""
    f = to_f32(image, resolve_device(device))
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the JAX package's rounding
    w = torch.tensor(float(weight), dtype=torch.float32, device=f.device)
    tau = 0.25  # skimage's working step; Chambolle 2004 proves 1/8

    def step(py, px):
        """One iteration, in place: the gradient reads both old fields first."""
        gy, gx = _grad(_div(py, px) - f / w)
        denom = 1.0 + tau * torch.sqrt(gy * gy + gx * gx)
        torch.div(py + tau * gy, denom, out=py)
        torch.div(px + tau * gx, denom, out=px)
        return dict(py=py, px=px)

    state = dict(py=torch.zeros_like(f), px=torch.zeros_like(f))
    state, _, _, _ = rl_mm._solve_outers(step, state, iterations=int(iterations),
                                         use_stopping=False, read=False)
    return f - w * _div(state["py"], state["px"])
