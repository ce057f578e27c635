"""TV-PD: deconvolution by the Chambolle-Pock primal-dual algorithm
(counterpart of ics_tpu/models/rl_pd.py).

Solves  min_u ½‖k∗u − f‖² + λ·‖∇u‖₁  with the gradient operator dualized:

  y   ← Π_{‖·‖∞≤λ} ( y + σ ∇ū )                     (dual ascent + projection)
  u   ← (|K̂|² + 1/τ)⁻¹ F⁻¹[ conj(K̂)·F(f) + F(u − τ ∇ᵀy)/τ ]   (data prox, FFT)
  ū  ← 2u − u_prev                                   (extrapolation)

The data prox inverts a circular forward model at the frame's own size;
``_edgetaper`` first blends the borders toward the circularly blurred image
(MATLAB ``edgetaper``'s construction) so the wrap seam does not drive the
solve.  Blind mode alternates a PSF gradient step with the simplex
projection, as TV-PAM does.

Backends: the prox, the residual and the taper are ``torch.fft.rfft2`` /
``irfft2`` (cuFFT on CUDA tensors), where the JAX package runs ``jnp.fft``
outside any Pallas kernel.  The transforms keep the frame's size even where
it is a prime length (4003 rows at 24 MP): padding to a fast length would
change the circular model and the answer.  The blind PSF gradient, the
correlation of the wrap-padded ``u`` with the circular residual, is K3's
function ``rot180(corr_valid(u, error))`` and runs on K3 (its plain twin on
CPU tensors).  The outer loop is the MM solver's device-state loop
(``rl_mm._solve_outers``): the state (u, ū, the dual field, the PSF, its
spectra, the residual) at fixed addresses, the whiteness stop decided on
the device by K7, and on CUDA every outer after the first in one launch of
a WHILE graph with one host read, as JAX's ``lax.while_loop``.

State is planar (C, H, W): ``_grad``, ``_div``, ``_edgetaper`` and
``_psf_otf`` take planar tensors and transform the last two axes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ics_tpu_torch._device import exact_f32, resolve_device
from ics_tpu_torch.models.rl_mm import RLResult, _hwc, _planar, _solve_outers, final_stats
from ics_tpu_torch.ops.cuda_correlate import psf_gradient_planar
from ics_tpu_torch.ops.psf import project_planar
from ics_tpu_torch.ops.reductions import whiteness_weights

__all__ = ["richardson_lucy_PD", "PDConfig"]

_INNER_ITER = 5


@dataclasses.dataclass(frozen=True)
class PDConfig:
    """Chambolle-Pock parameters, with the JAX package's defaults (the
    measured winner of its (λ_tv × step) grid on the golden blind-deblur
    protocol, ics_tpu/models/rl_pd.py:44-69).  Any σ·τ·8 ≤ 1 converges
    (L² = 8 for the gradient operator).  ``edgetaper`` blends the borders
    toward the circularly blurred image before the Fourier data prox."""

    lambda_tv: float = 1e-4  # TV weight
    sigma: float = 0.05  # dual step
    tau: float = 0.05  # primal step
    theta: float = 1.0  # extrapolation
    edgetaper: bool = True  # taper borders toward k∗f before the FFT prox


def _grad(u):
    """Forward differences with periodic wrap of planar u: (dy, dx)."""
    return torch.roll(u, -1, dims=-2) - u, torch.roll(u, -1, dims=-1) - u


def _div(py, px):
    """Adjoint: -grad^T. div at (i,j) = py[i]-py[i-1] + px[j]-px[j-1]."""
    return (py - torch.roll(py, 1, dims=-2)) + (px - torch.roll(px, 1, dims=-1))


def _edgetaper(image, psf, otf):
    """J = α · f + (1 − α) · (k ∗_circ f) of planar (C, M, N) ``image``,
    with α the separable window built from each axis' normalized PSF
    projection autocorrelation: exactly 1 beyond the PSF support, so only
    the wrap seam sees the blurred blend (ics_tpu/models/rl_pd.py:84-123)."""
    m, n = image.shape[-2:]

    def axis_alpha(size, proj):
        # periodic autocorrelation of the projection at length size-1
        # (MATLAB's construction), normalized
        z = torch.fft.irfft(torch.abs(torch.fft.rfft(proj, size - 1)) ** 2, size - 1)
        z = torch.cat([z, z[:1]])
        return 1.0 - z / torch.amax(z)

    psf2 = torch.mean(psf, dim=0)
    alpha = axis_alpha(m, torch.sum(psf2, dim=1))[:, None] * axis_alpha(
        n, torch.sum(psf2, dim=0))[None, :]
    blurred = torch.fft.irfft2(otf * torch.fft.rfft2(image), s=(m, n)).float()
    return alpha * image + (1.0 - alpha) * blurred


def _psf_otf(psf, m, n):
    """rfft2 of the planar PSF zero-padded to (m, n) with its center tap
    ``(mk-1)//2`` at (0, 0): the scipy 'same' centering of the spatial
    backends, so an even PSF does not shift the model by one pixel."""
    c_, mk, nk = psf.shape
    c = (mk - 1) // 2
    p = torch.zeros((c_, m, n), dtype=psf.dtype, device=psf.device)
    p[:, :mk, :nk] = psf
    return torch.fft.rfft2(torch.roll(p, shifts=(-c, -c), dims=(-2, -1)))


def _solve_pd(image, u0, psf, weights, *, top, bottom, left, right, tau_stop, step_factor,
              lambda_tv, sigma, tau, theta, iterations, blind, correlation,
              use_stopping=True, edgetaper=True):
    """One solve on planar (C, M, N) float32 tensors of one device (``u0``
    image-sized); returns (u, psf, stats) with stats [iterations, converged,
    M_r, Hu, varu], as the JAX ``_solve_pd`` returns them."""
    exact_f32()
    dev = u0.device
    _, m, n = image.shape
    mk = psf.shape[1]
    p = mk // 2
    weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    sf_mk = float(np.float32(step_factor) / np.float32(mk))  # the f32 quotient JAX takes
    inv_mn3 = 1.0 / (m * n * 3)

    otf = _psf_otf(psf, m, n)
    if edgetaper:
        # tapered with the initial PSF: the taper only needs its support
        image = _edgetaper(image, psf, otf)
    f_hat = torch.fft.rfft2(image)

    def prox_terms(otf):
        """The data prox's two spectra that change only with the PSF."""
        return torch.conj(otf) * f_hat, torch.abs(otf) ** 2 + 1.0 / tau

    def residual(u, otf):
        """Circular-model residual k∗u − f (matches the data term)."""
        return torch.fft.irfft2(otf * torch.fft.rfft2(u), s=(m, n)).float() - image

    def outer(u, u_bar, py, px, psf, otf, kf, den, error):
        for _ in range(_INNER_ITER):
            # dual ascent on the gradient, projected onto the λ ball
            gy, gx = _grad(u_bar)
            py = py + sigma * gy
            px = px + sigma * gx
            mag = torch.clamp(torch.sqrt(py**2 + px**2) / lambda_tv, min=1.0)
            py = py / mag
            px = px / mag
            # primal descent and the exact data prox
            u_prev = u
            v = u + tau * _div(py, px)
            u = torch.fft.irfft2((kf + torch.fft.rfft2(v) / tau) / den, s=(m, n)).float()
            u_bar = u + theta * (u - u_prev)
            if blind:
                # dE/dk = u ⋆ (k∗u − f) on the wrap-padded u: the adjoint of
                # the circular model (a zero pad would bias the border taps)
                error = residual(u, otf)
                u_wrap = F.pad(u[None], (p, p, p, p), mode="circular")[0]
                gradk = psf_gradient_planar(u_wrap, error)  # K3 on CUDA tensors
                dtpsf = sf_mk * (torch.amax(psf) + inv_mn3) / (
                    torch.amax(torch.abs(gradk)) + 1e-15
                )
                psf = project_planar(psf - dtpsf * gradk, correlation)
                otf = _psf_otf(psf, m, n)
                kf, den = prox_terms(otf)
        if not blind:
            # only the post-loop residual is read (whiteness, final Hu)
            error = residual(u, otf)
        return dict(u=u, u_bar=u_bar, py=py, px=px, psf=psf, otf=otf, kf=kf, den=den,
                    error=error)

    kf, den = prox_terms(otf)
    # u and ū start equal, as distinct tensors: the device-state loop
    # updates the state in place, and the inputs stay as they are
    state = dict(u=u0.clone(), u_bar=u0.clone(), py=torch.zeros_like(u0),
                 px=torch.zeros_like(u0), psf=psf.clone(), otf=otf, kf=kf, den=den, error=torch.zeros_like(image))
    state, it, stop, m_r = _solve_outers(
        outer, state, iterations=iterations, window=(top, bottom, left, right),
        weights=weights, blind=blind, tau=tau_stop, use_stopping=use_stopping)
    # the inset-window convention of the reference, MM and PAM
    u = state["u"]
    return u, state["psf"], final_stats(it, stop, m_r, state["error"], u,
                                        window=(top, bottom, left, right), pad=p)


def richardson_lucy_PD(
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
    config: PDConfig | None = None,
    device="cuda",
) -> RLResult:
    """TV-PD deconvolution.  ``u`` may be image-sized or padded like the MM
    solver's (the pad is cropped away: PD works at image size with a
    circular model).  Arrays are moved to ``device``; the result has no
    ``u_full``."""
    del lambd
    cfg = config or PDConfig()
    dev = resolve_device(device)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
    image, u = as_t(image), as_t(u)
    m, n, _ = image.shape
    if u.shape[0] != m:
        pad = (u.shape[0] - m) // 2
        u = u[pad : pad + m, pad : pad + n]
    u_out, psf_out, stats = _solve_pd(
        _planar(image), _planar(u), _planar(as_t(psf)),
        whiteness_weights(bottom - top, right - left),
        top=int(top), bottom=int(bottom), left=int(left), right=int(right),
        tau_stop=float(tau), step_factor=float(step_factor),
        lambda_tv=float(cfg.lambda_tv), sigma=float(cfg.sigma), tau=float(cfg.tau),
        theta=float(cfg.theta), iterations=int(iterations), blind=bool(blind),
        correlation=bool(correlation), edgetaper=bool(cfg.edgetaper),
    )
    return RLResult(u=_hwc(u_out), psf=_hwc(psf_out), image=image, stats=stats)
