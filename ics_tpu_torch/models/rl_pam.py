"""TV-PAM: blind / non-blind deconvolution by Projected Alternating
Minimization (counterpart of ics_tpu/models/rl_pam.py; Perrone & Favaro,
"Total Variation Blind Deconvolution: The Devil is in the Details", CVPR
2014).

PAM minimizes  E(u, k) = ½‖k∗u − f‖² + λ_tv · TV(u)  by alternating
projected gradient steps:

  u ← u − ε_u · [ kᵀ∗(k∗u − f) − λ_tv · div(∇u/|∇u|_ε) ]
  k ← Π_Δ[ k − ε_k · u⋆(k∗u − f) ]          (blind only)

with Π_Δ the clamp-and-rescale simplex projection of ``normalize_kernel``.
Five inner steps run per outer iteration; the outer loop is Python that
reads the whiteness stop flag on the host once per outer iteration, where
the JAX ``lax.while_loop`` tests it (as in ``rl_mm.py``).

Backends, per inner step, on CUDA tensors (their plain twins on CPU ones):
the two data-term convolutions go through the convolution dispatch (K1 for
PSFs up to 31x31), the TV curvature through K5 (order 2, L2), and the blind
PSF gradient ``conv_valid(rot180(u), error)`` through K3, which computes
exactly ``rot180(corr_valid(u, error))`` without a rotated copy.  The JAX
package reaches that gradient through its convolution dispatch, which sends
it to the FFT backend only because the residual is passed as the "kernel"
(ics_tpu/ops/conv.py:436-437); K3 is the port's route for every float32
blind solve, as in the MM solver.

State is planar (C, H, W); the public function takes and returns the JAX
package's (H, W, C) layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ics_tpu_torch._device import exact_f32, resolve_device
from ics_tpu_torch.models.rl_mm import RLResult, _hwc, _planar, final_stats, whiteness_stop
from ics_tpu_torch.ops.conv import conv_planar
from ics_tpu_torch.ops.cuda_correlate import psf_gradient_planar
from ics_tpu_torch.ops.psf import project_planar
from ics_tpu_torch.ops.reductions import whiteness_weights
from ics_tpu_torch.ops.tv import tv_auto_planar

__all__ = ["richardson_lucy_PAM", "PAMConfig"]

_INNER_ITER = 5


@dataclasses.dataclass(frozen=True)
class PAMConfig:
    lambda_tv: float = 2e-3  # TV weight (paper's λ; decoupled from the MM λ)
    epsilon: float = 1e-3  # TV ε-regularization
    conv_method: str = "auto"


def _solve_pam(image, u, psf, weights, *, top, bottom, left, right, tau, step_factor,
               lambda_tv, epsilon, iterations, blind, correlation, conv_method="auto",
               use_stopping=True):
    """One solve on (H, W, C) float32 tensors of one device; returns
    (u_out, psf, stats) with stats [iterations, converged, M_r, Hu, varu],
    as the JAX ``_solve_pam`` returns them."""
    exact_f32()
    if conv_method != "auto":
        raise NotImplementedError(
            f"conv_method={conv_method!r}: the port picks each convolution's "
            "backend from its dtype, precision and size (ROADMAP, 'Not "
            "ported, on purpose')"
        )
    dev = u.device
    image, u, psf = _planar(image), _planar(u), _planar(psf)
    _, m, n = image.shape
    _, u_m, u_n = u.shape
    mk = psf.shape[1]
    pad = (u_m - m) // 2
    weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    sf = float(np.float32(step_factor))
    sf_mk = float(np.float32(sf) / np.float32(mk))  # the f32 quotient JAX takes
    inv_un, inv_un3 = 1.0 / (u_m * u_n), 1.0 / (u_m * u_n * 3)
    psf_rot = torch.flip(psf, dims=(1, 2)).contiguous()
    error = torch.zeros_like(image)
    window = (top, bottom, left, right)
    m_r = m_r_prev = torch.zeros((), dtype=torch.float32, device=dev)
    it, stop = 0, False

    while it < iterations and not stop:
        for _ in range(_INNER_ITER):
            # data-term gradient kᵀ∗(k∗u − f), full support
            error = conv_planar(u, psf, "valid") - image
            grad_data = conv_planar(error, psf_rot, "full")
            # TV curvature: K5's div is the normalized negative divergence
            # of the order-2 stencil; over the ε-magnitude it is the
            # gradient of TV
            tv_mag, tv_div = tv_auto_planar(u, epsilon, 2, 2)
            grad_tv = torch.where(tv_mag > 0.0, tv_div / tv_mag, 0.0)
            gradu = grad_data + lambda_tv * grad_tv
            # the MM solver's adaptive step, per channel
            dt = sf * (torch.amax(u, dim=(1, 2)) + inv_un) / (
                torch.amax(torch.abs(gradu), dim=(1, 2)) + 1e-15
            )
            u = u - dt[:, None, None] * gradu
            if blind:
                error = conv_planar(u, psf, "valid") - image
                gradk = psf_gradient_planar(u, error)  # K3 on CUDA tensors
                dtpsf = sf_mk * (torch.amax(psf) + inv_un3) / (
                    torch.amax(torch.abs(gradk)) + 1e-15
                )
                psf = project_planar(psf - dtpsf * gradk, correlation)
                psf_rot = torch.flip(psf, dims=(1, 2)).contiguous()
        if use_stopping:
            m_r, m_r_prev, hit = whiteness_stop(
                error, it, m_r, m_r_prev, window=window, weights=weights, blind=blind,
                tau=tau)
            stop = it > 1 and bool(hit)  # the one host read of this outer
        it += 1

    stats = final_stats(it, stop, m_r, error, u, window=window, pad=pad)
    return _hwc(u[:, pad : pad + m, pad : pad + n]), _hwc(psf), stats


def richardson_lucy_PAM(
    image,
    u,
    psf,
    top: int,
    bottom: int,
    left: int,
    right: int,
    tau: float,
    iterations: int = 200,
    step_factor: float = 1e-3,
    lambd: float = 10000.0,
    blind: bool = True,
    correlation: bool = False,
    config: PAMConfig | None = None,
    device="cuda",
) -> RLResult:
    """TV-PAM deconvolution with the MM solver's calling convention.

    ``lambd`` is accepted for signature parity with ``richardson_lucy_MM``
    but the TV weight is ``config.lambda_tv`` (the PAM energy uses the
    paper's parameterization).  ``image`` (M, N, 3), ``u`` (M+2*pad,
    N+2*pad, 3) and ``psf`` (MK, MK, 3) are moved to ``device``; the result
    has no ``u_full``.
    """
    del lambd
    cfg = config or PAMConfig()
    dev = resolve_device(device)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
    image = as_t(image)
    u_out, psf_out, stats = _solve_pam(
        image, as_t(u), as_t(psf), whiteness_weights(bottom - top, right - left),
        top=int(top), bottom=int(bottom), left=int(left), right=int(right),
        tau=float(tau), step_factor=float(step_factor), lambda_tv=float(cfg.lambda_tv),
        epsilon=float(cfg.epsilon), iterations=int(iterations), blind=bool(blind),
        correlation=bool(correlation), conv_method=cfg.conv_method,
    )
    return RLResult(u=u_out, psf=psf_out, image=image, stats=stats)
