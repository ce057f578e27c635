"""Blind / non-blind Richardson-Lucy deconvolution, Minimization-Maximization
scheme, in parity mode (counterpart of ics_tpu/models/rl_mm.py).

An outer loop that stops on the residual-whiteness criterion runs around
five inner iterations of: residual, correlation with the PSF, depth-of-field
weights, regularized gradient step, DoF blend and (blind) PSF refinement.
The JAX package runs both loops as one on-device program; PyTorch has no
on-device while loop, so the outer loop here is Python that reads the stop
flag on the host once per outer iteration, where ``lax.while_loop`` tests
it (ics_tpu/models/rl_mm.py:598-600).  Checking less often would change the
outer count.

Inner loop, per outer iteration: on CUDA, the one-launch kernel K2
(ops/cuda_solver.py) where the JAX package ran its one-launch kernel
(float32, unguarded, no TV, window inside its bound); else the op-level loop
on the convolution dispatch (K1, K4s under ``conv_precision='high'``, K4 for
bf16 operands), the K3 PSF gradient (float32 blind solves) and the K5 TV
stencil (``use_tv``); on the CPU, the op-level loop on the plain twins.

State inside the solver is planar (C, H, W) and contiguous; the public
functions take and return the JAX package's (H, W, C) layout.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ics_tpu_torch._device import exact_f32, resolve_device
from ics_tpu_torch.ops.conv import _autocorrelate_planar, conv_planar
from ics_tpu_torch.ops.cuda_correlate import psf_gradient_planar
from ics_tpu_torch.ops.cuda_solver import fits, inner_loop_ops, inner_loop_planar
from ics_tpu_torch.ops.reductions import whiteness_weights
from ics_tpu_torch.ops.tv import tv_auto_planar

__all__ = ["richardson_lucy_MM", "RLConfig", "RLResult", "print_solver_report"]

_EPS_BLIND = 1e-2  # ref lib/deconvolution.pyx:435
_EPS_NONBLIND = 1e-6  # ref lib/deconvolution.pyx:437
_TV_NORMS = {"channel": False, "collab": "sup", "collab_l2": "l2"}


@dataclasses.dataclass(frozen=True)
class RLConfig:
    """Solver options beyond the reference's kwarg surface, with the JAX
    package's names and meanings (ics_tpu/models/rl_mm.py:52-187).

    ``conv_method`` other than 'auto' raises ``NotImplementedError``: the
    port picks each convolution's backend from its dtype, precision and
    size (ROADMAP "Not ported, on purpose").
    """

    use_tv: bool = False  # False = as-checked-in parity; True = intended MM math
    # 'auto' | 'xla' | 'pallas', for API parity: every TV stencil runs K5
    # on CUDA tensors and its plain twin on CPU ones
    tv_method: str = "auto"
    tv_norm: str = "channel"  # 'channel' | 'collab' | 'collab_l2'
    conv_method: str = "auto"
    # 'exact': float32 convs; 'high': f32 convs of 81-961 taps through the
    # bf16x3 split kernel K4s (about 1e-6 relative, not bit parity);
    # 'fast': the JAX package's single-pass MXU convs, exact f32 here (its
    # own stencil and Pallas paths are exact f32 too)
    conv_precision: str = "exact"
    # 'float32' (parity) | 'mixed' (non-blind solves: bf16 convs through
    # K4, f32 iterate and incremental f32 residual) | 'bfloat16' (all bf16)
    dtype: str = "float32"
    # blind PSF gradient: 'auto' and 'pallas' = K3 for float32 solves,
    # 'conv' = the FFT convolution (the only path in bf16)
    psf_grad: str = "auto"
    # Record per-outer-iteration (M_r, Hu, varu) in RLResult.trajectory.
    record_metrics: bool = False
    # DoF guard: dof = 1 where gradu + image == 0, and dof <= 1.  None =
    # auto: on for 'mixed' and 'bfloat16', off for 'float32'.
    dof_guard: bool | None = None
    # Opt-in whiteness-plateau stop for non-blind solves: stop once M_r has
    # not improved by a cumulative relative ``early_stop`` over
    # ``early_stop_patience`` consecutive outers (0 = reference parity).
    early_stop: float = 0.0
    early_stop_patience: int = 10
    # Vestigial reference kwargs, accepted for API parity and unused.
    p: float = 1.0
    norm: int = 1
    order: int = 2
    priority: float = 0.0
    refocus: bool = False


@dataclasses.dataclass
class RLResult:
    """Solver result.  The scalar statistics stay in one packed device tensor
    ``[iterations, converged, M_r, Hu, varu]`` until a property reads them."""

    u: torch.Tensor  # deconvolved image, cropped to (M, N, 3)
    psf: torch.Tensor  # (refined, if blind) PSF, (MK, MK, 3)
    image: torch.Tensor  # the observed image
    stats: torch.Tensor  # [iterations, converged, M_r, Hu, varu]
    # the whole solver window (M+2*pad, N+2*pad, 3), halo ring included:
    # the pipeline's blind write-back covers all of it
    u_full: torch.Tensor | None = None
    # per-outer (M_r, Hu, varu), when RLConfig.record_metrics is set
    trajectory: dict | None = None
    _stats_host: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def _fetch(self) -> np.ndarray:
        if self._stats_host is None:
            self._stats_host = self.stats.detach().cpu().numpy()
        return self._stats_host

    @property
    def iterations(self) -> int:  # outer iterations actually run
        return int(self._fetch()[0])

    @property
    def converged(self) -> bool:  # whiteness stopping criterion met
        return bool(self._fetch()[1])

    @property
    def M_r(self) -> float:  # final residual-whiteness metric
        return float(self._fetch()[2])

    @property
    def Hu(self) -> float:  # final residual energy over the mask window
        return float(self._fetch()[3])

    @property
    def varu(self) -> float:  # final variance of u over the mask window
        return float(self._fetch()[4])


def _planar(a: torch.Tensor) -> torch.Tensor:
    return a.permute(2, 0, 1).contiguous()


def _hwc(a: torch.Tensor) -> torch.Tensor:
    return a.permute(1, 2, 0).contiguous()


def _solve(
    image,
    u,
    psf,
    weights,
    *,
    top,
    bottom,
    left,
    right,
    tau,
    step_factor,
    lambd,
    iterations,
    blind,
    correlation,
    use_tv=False,
    tv_method="auto",
    tv_norm="channel",
    conv_method="auto",
    conv_precision="exact",
    psf_grad="auto",
    dtype="float32",
    dof_guard=None,
    early_stop=0.0,
    early_stop_patience=10,
    use_stopping=True,
    record=False,
):
    """One solve on (H, W, C) tensors of one device; returns
    (u_out, u_full, psf, image, stats, hist) as the JAX ``_solve`` does."""
    exact_f32()
    if conv_precision not in ("exact", "high", "fast"):
        raise ValueError(
            f"unknown conv_precision {conv_precision!r} "
            "(use 'exact', 'high' or 'fast')"
        )
    if tv_norm not in _TV_NORMS:
        raise ValueError(
            f"unknown tv_norm {tv_norm!r} (use 'channel', 'collab' or"
            " 'collab_l2')"
        )
    if dtype not in ("float32", "mixed", "bfloat16"):
        raise ValueError(f"unknown dtype {dtype!r} (use 'float32', 'mixed' or 'bfloat16')")
    if psf_grad not in ("auto", "pallas", "conv"):
        raise ValueError(f"unknown psf_grad {psf_grad!r} (use 'auto', 'pallas' or 'conv')")
    if conv_method != "auto":
        raise NotImplementedError(
            f"conv_method={conv_method!r}: the port picks each convolution's "
            "backend from its dtype, precision and size (ROADMAP, 'Not "
            "ported, on purpose')"
        )
    dev = u.device
    f32 = torch.float32
    # mixed precision applies to non-blind solves (rl_mm.py:347-366)
    mixed = dtype == "mixed" and not blind
    compute = torch.bfloat16 if dtype == "bfloat16" else f32
    guard = dof_guard if dof_guard is not None else (mixed or compute != f32)
    epsilon = _EPS_BLIND if blind else _EPS_NONBLIND
    image = _planar(image.to(compute))
    u = _planar(u.to(compute))
    psf = _planar(psf.to(compute))
    _, m, n = image.shape
    _, u_m, u_n = u.shape
    pad = (u_m - m) // 2
    weights = torch.as_tensor(weights, dtype=f32, device=dev)

    if (dev.type == "cuda" and fits(u_m, u_n) and not use_tv and not guard
            and compute == f32 and not mixed):
        def inner(u, image, psf, **kw):
            return *inner_loop_planar(u, image, psf, **kw), image
    else:
        conv = functools.partial(
            conv_planar, precision="bf16x3" if conv_precision == "high" else "exact"
        )
        if psf_grad != "conv" and compute == f32:
            grad = psf_gradient_planar  # K3 on CUDA tensors
        else:
            grad = lambda u, err: conv(torch.flip(u, dims=(1, 2)), err, "valid")
        collab = _TV_NORMS[tv_norm]
        tv = (lambda a, norm: tv_auto_planar(a, epsilon, 2, norm, tv_method, collab)
              ) if use_tv else None

        def inner(u, image, psf, **kw):
            return inner_loop_ops(
                u, image, psf, conv=conv, psf_grad=grad, guard=guard,
                mixed=mixed, tv=tv, **kw
            )

    zero = torch.zeros((), dtype=f32, device=dev)
    tau_t = torch.tensor(tau, dtype=f32, device=dev)
    m_r = m_r_prev = zero
    m_r_best = torch.tensor(float("inf"), dtype=f32, device=dev)
    since_best = 0
    error = torch.zeros_like(image)
    it, stop = 0, False
    hist = {"M_r": [], "Hu": [], "varu": []}
    win = (bottom - top) * (right - left) * 3

    while it < iterations and not stop:
        u, psf, error, image = inner(
            u, image, psf, step_factor=step_factor, lambd=lambd, blind=blind,
            correlation=correlation,
        )

        if use_stopping:
            # residual whiteness (Almeida & Figueiredo; ref :620-654)
            patch = error[:, top:bottom, left:right].float()
            test = (patch - torch.mean(patch)) / torch.std(patch, correction=0)
            test = test / torch.amax(torch.abs(test))
            ac = _autocorrelate_planar(test)
            m_r_new = torch.mean(ac * ac * weights)
            m_r_prev_new = m_r if it > 0 else m_r_prev
            if blind:
                hit = m_r_new > m_r_prev_new  # ref :646
            else:
                hit = (m_r_new - m_r_prev_new) / (m_r_new + m_r_prev_new) > tau_t
            flags = [hit]
            if early_stop > 0.0 and not blind:
                # whiteness-plateau stop (RLConfig.early_stop); the anchor
                # only moves once a full threshold's improvement accumulated
                improved = m_r_new < m_r_best * (1.0 - early_stop)
                m_r_best = torch.where(improved, m_r_new, m_r_best)
                flags.append(improved)
            # the one host read of this outer iteration
            flags = torch.stack(flags).tolist()
            stop = it > 1 and flags[0]
            if len(flags) > 1:
                since_best = 0 if flags[1] else since_best + 1
                stop = stop or (it > 1 and since_best >= early_stop_patience)
            m_r, m_r_prev = m_r_new, m_r_prev_new

        if record:
            u_win = u[:, top + pad : bottom - pad, left + pad : right - pad].float()
            err_win = error[:, top:bottom, left:right].float()
            hist["M_r"].append(m_r)
            hist["Hu"].append(torch.sum(err_win**2) / win)
            hist["varu"].append(torch.std(u_win, correction=0) ** 2)
        it += 1

    # final stats over the mask window (ref :600-601)
    u, psf, image, error = u.float(), psf.float(), image.float(), error.float()
    u_win = u[:, top + pad : bottom - pad, left + pad : right - pad]
    varu = torch.std(u_win, correction=0) ** 2
    err_win = error[:, top:bottom, left:right]
    hu = torch.sum(err_win**2) / win
    stats = torch.stack([
        torch.tensor(float(it), dtype=f32, device=dev),
        torch.tensor(float(stop), dtype=f32, device=dev),
        m_r.to(f32), hu, varu,
    ])
    u_out = _hwc(u[:, pad : pad + m, pad : pad + n])
    hist = {k: torch.stack(v) if v else torch.zeros(0, dtype=f32, device=dev)
            for k, v in hist.items()}
    return u_out, _hwc(u), _hwc(psf), _hwc(image), stats, hist


def richardson_lucy_MM(
    image,
    u,
    psf,
    top: int,
    bottom: int,
    left: int,
    right: int,
    tau: float,
    M: int | None = None,
    N: int | None = None,
    C: int = 3,
    MK: int | None = None,
    iterations: int = 200,
    step_factor: float = 1e-3,
    lambd: float = 10000.0,
    blind: bool = True,
    correlation: bool = False,
    p: float = 1.0,
    norm: int = 1,
    order: int = 2,
    priority: float = 0.0,
    refocus: bool = False,
    config: RLConfig | None = None,
    verbose: bool = False,
    device="cuda",
) -> RLResult:
    """Blind / non-blind RL-TV-MM deconvolution (reference-compatible API).

    ``image`` (M, N, 3), ``u`` (M+2*pad, N+2*pad, 3) and ``psf`` (MK, MK, 3)
    are NumPy arrays or tensors; they are moved to ``device``.  M, N, C, MK
    are derived from the shapes; ``p/norm/order/priority/refocus`` are
    vestigial in the reference.  Inputs are not mutated.
    """
    cfg = config or RLConfig(
        p=p, norm=norm, order=order, priority=priority, refocus=refocus
    )
    dev = resolve_device(device)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
    u_out, u_full, psf_out, image_out, stats, hist = _solve(
        as_t(image), as_t(u), as_t(psf),
        whiteness_weights(bottom - top, right - left),
        top=int(top), bottom=int(bottom), left=int(left), right=int(right),
        tau=float(tau), step_factor=float(step_factor), lambd=float(lambd),
        iterations=int(iterations), blind=bool(blind),
        correlation=bool(correlation), use_tv=cfg.use_tv,
        tv_method=cfg.tv_method, tv_norm=cfg.tv_norm,
        conv_method=cfg.conv_method, conv_precision=cfg.conv_precision,
        psf_grad=cfg.psf_grad, dtype=cfg.dtype, dof_guard=cfg.dof_guard,
        early_stop=cfg.early_stop, early_stop_patience=cfg.early_stop_patience,
        record=cfg.record_metrics,
    )
    result = RLResult(
        u=u_out, psf=psf_out, image=image_out, stats=stats, u_full=u_full
    )
    if cfg.record_metrics:
        result.trajectory = {k: v.cpu().numpy() for k, v in hist.items()}
    if verbose:
        print_solver_report(result, lambd, top, bottom, left, right)
    return result


def print_solver_report(
    result: RLResult, lambd: float, top: int, bottom: int, left: int, right: int
) -> None:
    """The reference's end-of-solve diagnostics (ref lib/deconvolution.pyx:
    661-672): convergence verdict, stats line, NaN warning."""
    if result.converged:
        print("Convergence after %i iterations." % result.iterations)
    else:
        print(
            "Did not converge after %i iterations. Don't use the result."
            % result.iterations
        )
    print(
        "Stats : autocovariance = %.6f | lamdba = %.0f | residual = %.6f | variance/noise = %.6f"
        % (
            1000 * result.M_r / ((bottom - top) * (right - left) * 3),
            lambd,
            result.Hu,
            result.varu,
        )
    )
    if bool(torch.isnan(result.u).any()):
        print("has NaN after DoF correction")
