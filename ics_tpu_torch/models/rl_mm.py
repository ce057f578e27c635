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

Inner loop, per outer iteration, as ``RLConfig.inner_loop`` routes it
(``inner_loop_route``): the one-launch kernel K2 (ops/cuda_solver.py), or
the op-level loop on the convolution dispatch (``RLConfig.conv_method``:
'auto' runs K1, K4s under ``conv_precision='high'`` and K4 for bf16
operands; 'pallas_mxu' K4h, K4s or K4d by ``conv_precision``), the K3 PSF
gradient (float32 blind solves) and the K5 TV stencil (``use_tv``).  K2
does its own convolutions, as JAX's kernel does, whatever
``conv_method`` says.  On the CPU, both run on the plain twins.

State inside the solver is planar (C, H, W) and contiguous; the public
functions take and return the JAX package's (H, W, C) layout.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ics_tpu_torch._device import exact_f32, resolve_device
from ics_tpu_torch.ops.conv import METHODS, _autocorrelate_planar, conv_planar
from ics_tpu_torch.ops.cuda_correlate import psf_gradient_planar
from ics_tpu_torch.ops.cuda_solver import fits, inner_loop_ops, inner_loop_planar
from ics_tpu_torch.ops.reductions import whiteness_weights
from ics_tpu_torch.ops.tv import _couple, tv_auto_planar

__all__ = ["richardson_lucy_MM", "RLConfig", "RLResult", "inner_loop_route",
           "print_solver_report"]

_EPS_BLIND = 1e-2  # ref lib/deconvolution.pyx:435
_EPS_NONBLIND = 1e-6  # ref lib/deconvolution.pyx:437
_TV_NORMS = {"channel": False, "collab": "sup", "collab_l2": "l2"}
_INNER_LOOPS = ("auto", "xla", "pallas", "pallas_unrolled")
# conv_precision -> ops/conv.py's precision (ics_tpu/models/rl_mm.py:313-317)
_CONV_PRECISIONS = {"exact": "exact", "high": "bf16x3", "fast": "fast"}


@dataclasses.dataclass(frozen=True)
class RLConfig:
    """Solver options beyond the reference's kwarg surface, with the JAX
    package's names and meanings (ics_tpu/models/rl_mm.py:52-187).

    ``conv_method`` routes the op loop's convolutions (``ops/conv.py``):
    'auto' (K1, or K4s under 'high', K4 on bf16 operands), 'pallas_mxu'
    and 'mxu' (K4h at 'exact', K4s at 'high', K4d at 'fast'; K4 on bf16),
    'pallas' and 'stencil' (K1), 'direct' (cuDNN, TF32 off) and 'fft'
    (cuFFT).
    """

    use_tv: bool = False  # False = as-checked-in parity; True = intended MM math
    # 'auto' | 'xla' | 'pallas', for API parity: every TV stencil runs K5
    # on CUDA tensors and its plain twin on CPU ones
    tv_method: str = "auto"
    tv_norm: str = "channel"  # 'channel' | 'collab' | 'collab_l2'
    conv_method: str = "auto"
    # 'exact': float32 convs (HIGHEST); 'high': f32 convs through the bf16x3
    # split kernel K4s (about 1e-6 relative, not bit parity), under 'auto'
    # those of 81-961 taps; 'fast': single-pass bf16 products (DEFAULT)
    # where the method is 'pallas_mxu' or 'mxu' (K4d), exact f32 under the
    # other methods (JAX's stencil and VPU Pallas paths are exact f32 too)
    conv_precision: str = "exact"
    # 'float32' (parity) | 'mixed' (non-blind solves: bf16 convs through
    # K4, f32 iterate and incremental f32 residual) | 'bfloat16' (all bf16)
    dtype: str = "float32"
    # blind PSF gradient: 'auto' and 'pallas' = K3 for float32 solves,
    # 'conv' = the FFT convolution (the only path in bf16)
    psf_grad: str = "auto"
    # 'auto' | 'xla' | 'pallas' | 'pallas_unrolled' (inner_loop_route):
    # 'xla' = the op loop; 'pallas' and 'pallas_unrolled' = K2 (one kernel,
    # already unrolled on mk), with the JAX package's fallbacks to the op
    # loop; 'auto' = K2 on CUDA where it takes the window, else the op loop
    inner_loop: str = "auto"
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
    """(H, W, C) to planar (C, H, W); a batch (B, H, W, C) folds its images
    into the channel axis, (B*C, H, W)."""
    if a.ndim == 4:
        return a.permute(0, 3, 1, 2).reshape(-1, *a.shape[1:3]).contiguous()
    return a.permute(2, 0, 1).contiguous()


def _hwc(a: torch.Tensor, lanes: int | None = None) -> torch.Tensor:
    """The inverse of ``_planar``; ``lanes`` unfolds a batch (B, H, W, C)."""
    if lanes is not None:
        return a.reshape(lanes, -1, *a.shape[1:]).permute(0, 2, 3, 1).contiguous()
    return a.permute(1, 2, 0).contiguous()


def whiteness_stop(error, it, m_r, m_r_prev, *, window, weights, blind, tau):
    """One outer iteration's residual-whiteness test (Almeida & Figueiredo;
    ref lib/deconvolution.pyx:620-654), shared by the MM, PAM and PD solvers.

    ``error`` is the planar residual; ``window`` is (top, bottom, left,
    right).  Returns (M_r, the M_r it was compared with, hit), all still on
    the device: the caller makes the one host read of its outer iteration.
    """
    top, bottom, left, right = window
    patch = error[:, top:bottom, left:right].float()
    test = (patch - torch.mean(patch)) / torch.std(patch, correction=0)
    test = test / torch.amax(torch.abs(test))
    ac = _autocorrelate_planar(test)
    m_r_new = torch.mean(ac * ac * weights)
    m_r_prev_new = m_r if it > 0 else m_r_prev
    if blind:
        hit = m_r_new > m_r_prev_new  # ref :646
    else:
        hit = (m_r_new - m_r_prev_new) / (m_r_new + m_r_prev_new) > tau
    return m_r_new, m_r_prev_new, hit


def final_stats(it, stop, m_r, error, u, *, window, pad):
    """``[iterations, converged, M_r, Hu, varu]`` over the mask window (ref
    :600-601): Hu over the residual's window, varu over ``u``'s, inset by
    ``pad``.  ``error`` and ``u`` are planar float32."""
    top, bottom, left, right = window
    f32, dev = torch.float32, u.device
    varu = torch.std(u[:, top + pad : bottom - pad, left + pad : right - pad], correction=0) ** 2
    hu = torch.sum(error[:, top:bottom, left:right] ** 2) / ((bottom - top) * (right - left) * 3)
    return torch.stack([
        torch.tensor(float(it), dtype=f32, device=dev),
        torch.tensor(float(stop), dtype=f32, device=dev),
        m_r.to(f32), hu, varu,
    ])


def inner_loop_route(inner_loop: str, *, device_type: str, fits: bool, use_tv: bool,
                     guard: bool, compute: torch.dtype, mixed: bool) -> str:
    """'kernel' (K2 on CUDA tensors, its plain twin ``inner_loop_plain`` on
    CPU ones) or 'ops' (``inner_loop_ops``), as ics_tpu/models/rl_mm.py:333-365
    routes ``inner_loop``: 'xla' is always the op loop; 'pallas' and
    'pallas_unrolled' fall back to it under ``use_tv``, a window that does
    not ``fits``, the DoF guard, bfloat16 or ``mixed``, where the JAX
    package falls back; 'auto' takes K2 on CUDA only, as JAX takes its
    kernel on the TPU only.  ``ICS_TPU_SOLVER_UNROLL`` is not read."""
    if inner_loop not in _INNER_LOOPS:
        raise ValueError(
            f"unknown inner_loop {inner_loop!r} (use 'auto', 'xla', 'pallas' or "
            "'pallas_unrolled')"
        )
    if inner_loop == "xla" or (inner_loop == "auto" and device_type != "cuda"):
        return "ops"
    if use_tv or not fits or guard or compute != torch.float32 or mixed:
        return "ops"
    return "kernel"


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
    inner_loop="auto",
    dtype="float32",
    dof_guard=None,
    early_stop=0.0,
    early_stop_patience=10,
    use_stopping=True,
    record=False,
    shard=None,
):
    """One solve on (H, W, C) tensors of one device; returns
    (u_out, u_full, psf, image, stats, hist) as the JAX ``_solve`` does.

    A batch (B, H, W, C) is solved as one: its images fold into the planar
    channel axis, so each convolution is one launch for all of them, while
    each image keeps its own PSF maxima and its own stop; an image that has
    stopped drops out of the fold and keeps its state.  Its stats are
    (B, 5).  ``shard`` (``parallel.tiling.RowShard``): the tensors are this
    rank's rows of a row-sharded solve; every rank reads the mask window
    whole, makes the same stop decision and returns the same stats.
    """
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
    if conv_method not in METHODS:
        raise ValueError(f"unknown conv_method {conv_method!r} (use {', '.join(METHODS)})")
    batch = image.shape[0] if image.ndim == 4 else None
    lanes, chans = batch or 1, image.shape[-1]
    if record and lanes > 1:
        raise ValueError("record_metrics takes one image, not a batch")
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
    if shard is not None:
        m, u_m = shard.rows, shard.u_rows
    pad = (u_m - m) // 2
    weights = torch.as_tensor(weights, dtype=f32, device=dev)

    route = inner_loop_route(inner_loop, device_type=dev.type,
                             fits=fits(u_m, u_n) and lanes == 1 and shard is None,
                             use_tv=use_tv, guard=guard, compute=compute, mixed=mixed)
    if route == "kernel":
        def inner(u, image, psf, lanes, **kw):
            return *inner_loop_planar(u, image, psf, **kw), image
    else:
        conv = functools.partial(conv_planar, precision=_CONV_PRECISIONS[conv_precision],
                                 method=conv_method)
        if psf_grad != "conv" and compute == f32:
            grad = psf_gradient_planar  # K3 on CUDA tensors
        else:
            grad = lambda u, err: conv(torch.flip(u, dims=(1, 2)), err, "valid")
        collab = _TV_NORMS[tv_norm]
        tv = (lambda a, norm: _tv_lanes(a, epsilon, norm, tv_method, collab,
                                        a.shape[0] // chans)) if use_tv else None

        def inner(u, image, psf, lanes, **kw):
            return inner_loop_ops(
                u, image, psf, conv=conv, psf_grad=grad, guard=guard,
                mixed=mixed, tv=tv, lanes=lanes, shard=shard, **kw
            )

    window = (top, bottom, left, right)

    def whole(x, space):
        """x's mask window, whole on every rank, and where to read it: the
        window of x itself on one device; under a shard, rows [top, bottom)
        and columns [left, right) of x ('u' or 'image' rows), gathered."""
        if shard is None:
            return x, window
        rows = shard.gather(x[:, :, left:right], top, bottom, space)
        return rows, (0, bottom - top, 0, right - left)

    lane = (lambda x, i: x) if lanes == 1 else (lambda x, i: x[chans * i : chans * (i + 1)])
    zero = torch.zeros((), dtype=f32, device=dev)
    m_r = [zero] * lanes
    m_r_prev = [zero] * lanes
    m_r_best = [torch.tensor(float("inf"), dtype=f32, device=dev)] * lanes
    since_best = [0] * lanes
    its, stops = [0] * lanes, [False] * lanes
    error = torch.zeros_like(image)
    hist = {"M_r": [], "Hu": [], "varu": []}
    win = (bottom - top) * (right - left) * 3
    active = list(range(lanes)) if iterations > 0 else []

    while active:
        kw = dict(step_factor=step_factor, lambd=lambd, blind=blind, correlation=correlation)
        if len(active) == lanes:
            u, psf, error, image = inner(u, image, psf, lanes, **kw)
        else:  # the images that go on, folded; the others keep their state
            ch = torch.tensor([chans * i + c for i in active for c in range(chans)], device=dev)
            outs = inner(*(t.index_select(0, ch) for t in (u, image, psf)), len(active), **kw)
            u, psf, error, image = (t.index_copy(0, ch, o)
                                    for t, o in zip((u, psf, error, image), outs))
        it = its[active[0]]

        if use_stopping:
            err_w, at = whole(error, "image")
            flags, per = [], 1 + (early_stop > 0.0 and not blind)
            for i in active:
                m_r_new, m_r_prev_new, hit = whiteness_stop(
                    lane(err_w, i), it, m_r[i], m_r_prev[i], window=at, weights=weights,
                    blind=blind, tau=tau)
                flags.append(hit)
                if per > 1:
                    # whiteness-plateau stop (RLConfig.early_stop); the anchor
                    # only moves once a full threshold's improvement accumulated
                    improved = m_r_new < m_r_best[i] * (1.0 - early_stop)
                    m_r_best[i] = torch.where(improved, m_r_new, m_r_best[i])
                    flags.append(improved)
                m_r[i], m_r_prev[i] = m_r_new, m_r_prev_new
            # the one host read of this outer iteration; under a shard every
            # rank reads the same flags, computed from the same gathered window
            flags = torch.stack(flags).tolist()
            for j, i in enumerate(active):
                stops[i] = it > 1 and flags[per * j]
                if per > 1:
                    since_best[i] = 0 if flags[per * j + 1] else since_best[i] + 1
                    stops[i] = stops[i] or (it > 1 and since_best[i] >= early_stop_patience)

        if record:
            (u_w, at), (err_w, _) = whole(u, "u"), whole(error, "image")
            t, b, l, r = at
            hist["M_r"].append(m_r[0])
            hist["Hu"].append(torch.sum(err_w[:, t:b, l:r].float() ** 2) / win)
            hist["varu"].append(
                torch.std(u_w[:, t + pad : b - pad, l + pad : r - pad].float(), correction=0) ** 2)
        for i in active:
            its[i] += 1
        active = [i for i in active if its[i] < iterations and not stops[i]]

    u, psf, image, error = u.float(), psf.float(), image.float(), error.float()
    (u_w, at), (err_w, _) = whole(u, "u"), whole(error, "image")
    stats = [final_stats(its[i], stops[i], m_r[i], lane(err_w, i), lane(u_w, i), window=at,
                         pad=pad) for i in range(lanes)]
    stats = stats[0] if batch is None else torch.stack(stats)
    rows = slice(pad, pad + m) if shard is None else shard.crop
    u_out = _hwc(u[:, rows, pad : pad + n], batch)
    hist = {k: torch.stack(v) if v else torch.zeros(0, dtype=f32, device=dev)
            for k, v in hist.items()}
    return u_out, _hwc(u, batch), _hwc(psf, batch), _hwc(image, batch), stats, hist


def _tv_lanes(a, epsilon, norm, method, collab, lanes):
    """The solver's TV stencil (K5) of planar ``a``; with ``lanes`` > 1 the
    channel coupling is taken within each image of the fold and broadcast
    back to its channels."""
    if lanes == 1 or not collab:
        return tv_auto_planar(a, epsilon, 2, norm, method, collab)
    mag, div = tv_auto_planar(a, epsilon, 2, norm, method, False)
    per = mag.reshape(lanes, -1, *mag.shape[1:])
    return _couple(per, collab, 1).expand_as(per).reshape(mag.shape), div


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
        psf_grad=cfg.psf_grad, inner_loop=cfg.inner_loop, dtype=cfg.dtype,
        dof_guard=cfg.dof_guard,
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
