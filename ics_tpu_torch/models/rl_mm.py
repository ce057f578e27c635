"""Blind / non-blind Richardson-Lucy deconvolution, Minimization-Maximization
scheme, in parity mode (counterpart of ics_tpu/models/rl_mm.py).

An outer loop that stops on the residual-whiteness criterion runs around
five inner iterations of: residual, correlation with the PSF, depth-of-field
weights, regularized gradient step, DoF blend and (blind) PSF refinement.
The JAX package runs both loops as one on-device program
(``lax.while_loop`` around ``lax.scan``, ics_tpu/models/rl_mm.py:500-627).
Here a one-image, unsharded solve keeps its outer state on its device, in
tensors updated in place, and decides its stop there (K7,
ops/cuda_outer.py).  On CUDA it runs outer 1 eagerly, captures one outer as
a CUDA graph and runs every later outer in one launch of a graph whose
WHILE node repeats that body while K7's ``go`` holds (K7w,
csrc/graph_while.cu), then reads the state once, as ``lax.while_loop``
tests ``outer_cond`` (:598-600) on the device.  On the CPU the same body
runs eagerly, with one read of the state per outer, and so does it on
CUDA inside ``_eager_outer_loop()`` and while torch's profiler runs
(``_eager_loop``): the profiler and the A/B hook run the captured body
outer by outer.  The PAM and PD solvers and ``tv_denoise`` run their outers
through the same loop (``_state_loop``).  Only a batch (the folded burst)
and a sharded solve keep a loop of their own, which stops on K7 per image
and reads the stop state once per outer.

Inner loop, per outer iteration, as ``RLConfig.inner_loop`` routes it
(``inner_loop_route``): the one-launch kernel K2 (ops/cuda_solver.py), or
the op-level loop on the convolution dispatch (``RLConfig.conv_method``:
'auto' runs K1, K4s under ``conv_precision='high'`` and K4 for bf16
operands; 'pallas_mxu' K4h, or K4d under 'fast'), the K3 PSF
gradient (float32 blind solves), the K5 TV stencil (``use_tv``) and K8, the
MM step (steps 4-8 of a float32 parity-mode solve, ``mm_step_route``).  K2
does its own convolutions, as JAX's kernel does, whatever
``conv_method`` says.  On the CPU, both run on the plain twins.

State inside the solver is planar (C, H, W) and contiguous; the public
functions take and return the JAX package's (H, W, C) layout.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import time

import numpy as np
import torch

from ics_tpu_torch._device import exact_f32, resolve_device
from ics_tpu_torch.ops import cuda_outer, cuda_step
from ics_tpu_torch.ops.conv import METHODS, _autocorrelate_planar, conv_planar
from ics_tpu_torch.ops.cuda_correlate import psf_gradient_planar
from ics_tpu_torch.ops.cuda_solver import fits, inner_loop_ops, inner_loop_planar
from ics_tpu_torch.ops.reductions import whiteness_weights
from ics_tpu_torch.ops.tv import _couple, tv_auto_planar
from ics_tpu_torch.utils import trace

__all__ = ["richardson_lucy_MM", "RLConfig", "RLResult", "inner_loop_route",
           "print_solver_report"]

_EPS_BLIND = 1e-2  # ref lib/deconvolution.pyx:435
_EPS_NONBLIND = 1e-6  # ref lib/deconvolution.pyx:437
_TV_NORMS = {"channel": False, "collab": "sup", "collab_l2": "l2"}
_INNER_LOOPS = ("auto", "xla", "pallas", "pallas_unrolled")
# conv_precision -> ops/conv.py's precision (ics_tpu/models/rl_mm.py:313-317)
_CONV_PRECISIONS = {"exact": "exact", "high": "bf16x3", "fast": "fast"}
_EAGER_LOOP = False  # set by _eager_outer_loop()
# one entry per device-state solve, newest last: its route ('while' on CUDA,
# 'host' on the CPU and, under the profiler or _eager_outer_loop(), on
# CUDA), outers run, host reads of the stop state, K7w's runs as K7w
# counted them on the card (None on the CPU, and until a fixed-count
# loop's count is read: _read_launches), and the host milliseconds of the
# body's capture and of the WHILE graph's build and instantiation (None
# without a graph); a 'while' entry also has ``body_nodes``, the captured
# body's graph nodes by type (ops/cuda_outer.py::graph_nodes), and
# ``body_launches``, each kernel wrapper's launches over the capture of one
# body, keyed by kernel (``_launch_counters``); both None without a graph.  A
# stamping tracer's solve spans keep their entries too (utils/trace.py),
# whatever this log's bound.
loop_log = collections.deque(maxlen=64)
# the fixed-count WHILE launches whose counts the host has not read yet:
# (loop_log entry, launches per captured body, the state's counts as copied
# to pinned host memory behind the launch, the event after that copy)
_UNREAD = []
# per CUDA device index: the memory pool and the stream of every body's
# capture, the event after the last WHILE launch, and the graph that keeps
# the pool alive (_capture_pool)
_POOLS = {}


@dataclasses.dataclass(frozen=True)
class RLConfig:
    """Solver options beyond the reference's kwarg surface, with the JAX
    package's names and meanings (ics_tpu/models/rl_mm.py:52-187).

    ``conv_method`` routes the op loop's convolutions (``ops/conv.py``):
    'auto' (K1, or K4s under 'high', K4 on bf16 operands), 'pallas_mxu'
    and 'mxu' (K4h at 'exact' and 'high', K4d at 'fast'; K4 on bf16),
    'pallas' and 'stencil' (K1), 'direct' (cuDNN, TF32 off) and 'fft'
    (cuFFT).
    """

    use_tv: bool = False  # False = as-checked-in parity; True = intended MM math
    # 'auto' | 'xla' | 'pallas', for API parity: every TV stencil runs K5
    # on CUDA tensors and its plain twin on CPU ones
    tv_method: str = "auto"
    tv_norm: str = "channel"  # 'channel' | 'collab' | 'collab_l2'
    conv_method: str = "auto"
    # 'exact': float32 convs (HIGHEST); 'high': under 'auto', f32 convs of
    # 81-961 taps through the bf16x3 split kernel K4s (about 1e-6 relative,
    # not bit parity), exact under every explicit method, as JAX's
    # _dispatch has it; 'fast': single-pass bf16 products (DEFAULT)
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


def whiteness_metric(error, *, window, weights):
    """The residual-whiteness metric M_r (Almeida & Figueiredo; ref
    lib/deconvolution.pyx:620-644) of the planar residual ``error`` over
    ``window`` (top, bottom, left, right), a 0-d tensor on its device."""
    top, bottom, left, right = window
    patch = error[:, top:bottom, left:right].float()
    test = (patch - torch.mean(patch)) / torch.std(patch, correction=0)
    test = test / torch.amax(torch.abs(test))
    ac = _autocorrelate_planar(test)
    return torch.mean(ac * ac * weights)


def final_stats(it, stop, m_r, error, u, *, window, pad):
    """``[iterations, converged, M_r, Hu, varu]`` over the mask window (ref
    :600-601): Hu over the residual's window, varu over ``u``'s, inset by
    ``pad``.  ``error`` and ``u`` are planar float32; ``it``, ``stop`` and
    ``m_r`` are 0-d tensors of K7's stop state on the device."""
    f32 = torch.float32
    return torch.stack([it.to(f32), stop.to(f32), m_r.to(f32), _hu(error, window),
                        _varu(u, window, pad)])


def _hu(error, window):
    """The residual energy over the mask window (ref :600, :585-587)."""
    top, bottom, left, right = window
    return (torch.sum(error[:, top:bottom, left:right].float() ** 2)
            / ((bottom - top) * (right - left) * 3))


def _varu(u, window, pad):
    """The variance of ``u`` over the mask window inset by ``pad`` (ref :601)."""
    top, bottom, left, right = window
    return torch.std(u[:, top + pad : bottom - pad, left + pad : right - pad].float(),
                     correction=0) ** 2


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


def mm_step_route(*, device_type: str, compute: torch.dtype, use_tv: bool, guard: bool,
                  mixed: bool, lanes: int, shard) -> bool:
    """Whether the op loop runs steps 4-8 as K8 (``cuda_step.mm_step``): on
    CUDA, in float32, in parity mode (no ``use_tv``, no DoF guard, not
    ``mixed``), one image and one device.  Blind and non-blind alike; every
    other solve keeps the tensor ops of ``inner_loop_ops``."""
    return (device_type == "cuda" and compute == torch.float32 and not use_tv and not guard
            and not mixed and lanes == 1 and shard is None)


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
        k8 = mm_step_route(device_type=dev.type, compute=compute, use_tv=use_tv, guard=guard,
                           mixed=mixed, lanes=lanes, shard=shard)

        def inner(u, image, psf, lanes, **kw):
            return inner_loop_ops(
                u, image, psf, conv=conv, psf_grad=grad, guard=guard,
                mixed=mixed, tv=tv, lanes=lanes, shard=shard,
                step=cuda_step.mm_step if k8 else None, **kw
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
    error = torch.zeros_like(image)
    kw = dict(step_factor=step_factor, lambd=lambd, blind=blind, correlation=correlation)
    stop_kw = dict(iterations=iterations, blind=blind, tau=tau, early_stop=early_stop,
                   patience=early_stop_patience, use_stopping=use_stopping)
    if lanes == 1 and shard is None:
        st = _Outer(iterations, record, u=u, psf=psf, error=error, image=image)

        def outer(u, psf, image, **_):
            return dict(zip(("u", "psf", "error", "image"), inner(u, image, psf, 1, **kw)))

        hist = _state_loop(outer, st, window=window, weights=weights, pad=pad, **stop_kw)
        u, psf, error, image = st.u, st.psf, st.error, st.image
        states = [(st.mr, st.ints, st.go)]
    else:  # the fold and shards: state rebound each outer, K7's stop per image
        states = [cuda_outer.initial_state(dev, iterations) for _ in range(lanes)]
        hist = {"M_r": [], "Hu": [], "varu": []}
        active = list(range(lanes)) if iterations > 0 else []

        while active:
            if len(active) == lanes:
                u, psf, error, image = inner(u, image, psf, lanes, **kw)
            else:  # the images that go on, folded; the others keep their state
                ch = torch.tensor([chans * i + c for i in active for c in range(chans)], device=dev)
                outs = inner(*(t.index_select(0, ch) for t in (u, image, psf)), len(active), **kw)
                u, psf, error, image = (t.index_copy(0, ch, o)
                                        for t, o in zip((u, psf, error, image), outs))
            if use_stopping:
                err_w, at = whole(error, "image")
            for i in active:
                mr, ints, go = states[i]
                m_r_new = (whiteness_metric(lane(err_w, i), window=at, weights=weights)
                           if use_stopping else mr[0])
                cuda_outer.outer_stop(m_r_new, mr, ints, go, **stop_kw)
            if record:
                (u_w, at), (err_w, _) = whole(u, "u"), whole(error, "image")
                hist["M_r"].append(states[0][0][0].clone())  # K7 updates mr in place
                hist["Hu"].append(_hu(err_w, at))
                hist["varu"].append(_varu(u_w, at, pad))
            # the one host read of this outer; under a shard every rank reads
            # the same state, decided from the same gathered window
            read = torch.stack([states[i][1] for i in active]).tolist()
            active = [i for i, (*_, more) in zip(active, read) if more]

    u, psf, image, error = u.float(), psf.float(), image.float(), error.float()
    (u_w, at), (err_w, _) = whole(u, "u"), whole(error, "image")
    stats = [final_stats(ints[0], ints[2], mr[0], lane(err_w, i), lane(u_w, i), window=at,
                         pad=pad) for i, (mr, ints, _) in enumerate(states)]
    stats = stats[0] if batch is None else torch.stack(stats)
    rows = slice(pad, pad + m) if shard is None else shard.crop
    u_out = _hwc(u[:, rows, pad : pad + n], batch)
    empty = torch.zeros(0, dtype=f32, device=dev)
    hist = {k: v if torch.is_tensor(v) else torch.stack(v) if v else empty
            for k, v in hist.items()}
    return u_out, _hwc(u, batch), _hwc(psf, batch), _hwc(image, batch), stats, hist


def _state_loop(outer, st, *, window=None, weights=None, pad=0, read=True, **stop_kw):
    """A one-image solve's outers on the state ``st`` (``_Outer``): the body
    is ics_tpu/models/rl_mm.py's ``outer_body`` (:500-596), PAM's and PD's
    (rl_pam.py:135-169, rl_pd.py:247-290): ``outer`` on the state's tensors
    (a dict of the next ones), M_r of its 'error' over ``window``, the
    record at index ``it``, K7's stop (``stop_kw``: ops/cuda_outer.py::
    outer_stop), then the new state copied into the tensors that the next
    outer reads.  CUDA runs it through ``_while_loop`` (``read``: whether
    the host reads the outer count; a fixed count needs no read); the CPU,
    and CUDA where ``_eager_loop()`` holds, through ``_host_loop``, outer
    by outer.  Returns the record."""

    def body():
        new = outer(**{name: getattr(st, name) for name in st.names})
        m_r_new = (whiteness_metric(new["error"], window=window, weights=weights)
                   if stop_kw["use_stopping"] else st.mr[0])
        if st.hist is not None:
            at = st.ints[:1].long()
            for key, value in (("M_r", m_r_new), ("Hu", _hu(new["error"], window)),
                               ("varu", _varu(new["u"], window, pad))):
                st.hist[key].index_copy_(0, at, value.reshape(1))
        cuda_outer.outer_stop(m_r_new, st.mr, st.ints, st.go, **stop_kw)
        st.store(**new)

    if st.go.device.type == "cuda" and not _eager_loop():
        outers = _while_loop(body, st, stop_kw["iterations"], read)
    else:
        outers = _host_loop(body, st, stop_kw["iterations"])
    return ({k: v[:outers] for k, v in st.hist.items()} if st.hist is not None
            else {"M_r": [], "Hu": [], "varu": []})


class _Outer:
    """A one-image solve's outer state on its device, at fixed addresses: the
    named tensors of its body (the MM solver's u, psf, error and image,
    PAM's, PD's, ``tv_denoise``'s), each an attribute, the stop state of K7
    (``mr``, ``ints``, ``go``: ops/cuda_outer.py), K7w's count of its runs
    (``k7w``, one int32 after ``ints`` in ``counts``, so that one copy reads
    both) and, with ``record``, the (iterations,) buffers of the per-outer
    M_r, Hu and varu."""

    def __init__(self, iterations, record=False, **tensors):
        self.names = tuple(tensors)
        for name, t in tensors.items():
            setattr(self, name, t)
        dev = next(iter(tensors.values())).device
        self.mr, ints, self.go = cuda_outer.initial_state(dev, iterations)
        self.counts = torch.cat([ints, ints.new_zeros(1)])
        self.ints, self.k7w = self.counts[:4], self.counts[4:]
        self.hist = {k: torch.zeros(iterations, dtype=torch.float32, device=dev)
                     for k in ("M_r", "Hu", "varu")} if record else None

    def store(self, **new):
        """Copy an outer's results into the state (a result that is already
        the state's tensor, as K2's in-place ``u``, stays)."""
        for name, t in new.items():
            old = getattr(self, name)
            if t is old:
                continue
            if t.dtype != old.dtype or t.shape != old.shape:
                raise RuntimeError(f"the outer body's {name} is {t.dtype} {tuple(t.shape)}, "
                                   f"its state {old.dtype} {tuple(old.shape)}")
            old.copy_(t)


def _solve_outers(outer, state: dict, *, iterations, window=None, weights=None, blind=False,
                  tau=0.0, use_stopping=True, read=True):
    """PAM's, PD's and ``tv_denoise``'s outers around ``outer`` (the state's
    tensors to the next ones, 'error' among them when ``use_stopping``) in
    the device-state loop (``_state_loop``; ``read`` False: no host read of
    a fixed count), stopped by K7 on the residual whiteness with no plateau,
    as JAX's ``outer_body``, or after ``iterations``.  The state's tensors
    must not share storage.  Returns (state, outers, stop, M_r); the last
    three are 0-d tensors on the device."""
    st = _Outer(iterations, **state)
    _state_loop(outer, st, window=window, weights=weights, read=read, iterations=iterations,
                blind=blind, tau=tau, use_stopping=use_stopping)
    return {name: getattr(st, name) for name in st.names}, st.ints[0], st.ints[2], st.mr[0]


def _host_loop(body, st, iterations):
    """The host's loop, on the CPU and on CUDA where ``_eager_loop()``
    holds: one body per outer, launched eagerly, then one read of the
    state."""
    outers, reads, go = 0, 0, iterations > 0
    while go:
        body()
        outers, _, _, go = st.ints.tolist()
        reads += 1
    loop_log.append(dict(route="host", outers=outers, reads=reads, k7w=None, capture_ms=None,
                         instantiate_ms=None))
    return outers


def _launch_counters():
    """(module, attribute, kernel) of every kernel wrapper's launch counter."""
    from ics_tpu_torch.ops import (cuda_bilateral, cuda_conv, cuda_conv_mma, cuda_correlate,
                                   cuda_solver, cuda_tv)

    return [(cuda_conv, "launches", "k1"), (cuda_solver, "launches", "k2"),
            (cuda_correlate, "launches", "k3"), (cuda_tv, "launches", "k5"),
            (cuda_bilateral, "launches", "k6"), (cuda_outer, "launches", "k7"),
            *((cuda_conv_mma, f"{v}_launches", k) for v, k in (
                ("split", "k4s"), ("bf16", "k4"), ("highest", "k4h"), ("default", "k4d"))),
            (cuda_step, "launches", "k8"), (cuda_outer, "while_launches", "k7w")]


def _launch_values() -> list[int]:
    return [getattr(mod, name) for mod, name, _ in _launch_counters()]


def _set_launches(values) -> None:
    for (mod, name, _), value in zip(_launch_counters(), values):
        setattr(mod, name, value)


def _read_launches() -> list[int]:
    """Every launch counter, once the WHILE launches not read yet are
    counted (``_settle_unread``)."""
    _settle_unread()
    return _launch_values()


def _write_launches(values) -> None:
    """Set every launch counter, once the WHILE launches not read yet are
    counted, so that none of them adds to the new values later."""
    _settle_unread()
    _set_launches(values)


def _count_replays(per_body, bodies: int) -> None:
    """A WHILE node's bodies call no wrapper: add each counter's change over
    the capture of one body, times the bodies that K7w counted."""
    _set_launches([v + d * bodies for v, d in zip(_launch_values(), per_body)])


def _settle(entry, per_body, counts) -> None:
    """Count a WHILE launch from its state as read back (``counts``: K7's
    ``[it, since_best, stop, go]``, then K7w's runs).  K7 adds one to ``it``
    in each body and K7w one to its runs before the node and after each
    body, so each is the outers run, and a fixed-count loop's is the count
    it was given (``entry['outers']``).  Raises when they differ."""
    outers, k7w = counts[0], counts[4]
    if k7w != outers or not (entry["reads"] or outers == entry["outers"]):
        want = "one K7w run per outer" + ("" if entry["reads"] else f", {entry['outers']} outers")
        raise RuntimeError(f"the WHILE launch ran {outers} outers by K7's count and {k7w} K7w "
                           f"runs; want {want}")
    _count_replays(per_body, k7w - 1)
    cuda_outer.while_launches += k7w
    entry.update(outers=outers, k7w=k7w)


def _settle_unread(wait=True) -> None:
    """Count the fixed-count WHILE launches (``tv_denoise``'s) that no solve
    has read, oldest first, from the copy of each one's counts: waiting for
    each copy, or without ``wait`` only the copies already done."""
    while _UNREAD and (wait or _UNREAD[0][3].query()):
        entry, per_body, host, copied = _UNREAD.pop(0)
        copied.synchronize()
        _settle(entry, per_body, host.tolist())


def _while_loop(body, st, iterations, read=True):
    """The CUDA loop.  Outer 1 runs eagerly: it makes the cuFFT plans, the
    allocator's blocks and each kernel's first call.  No stop fires before
    outer 3 (K7's test needs ``it`` > 1), so with ``iterations`` > 1 one
    body is captured at once, while the card still runs outer 1, as a CUDA
    graph in the device's capture pool, on its capture stream
    (``_capture_pool``; the wrappers count no launch for it).
    The WHILE graph around it (ops/cuda_outer.py::while_build) runs every
    later outer in one launch on the current stream.  With ``read`` the
    host then reads the state and K7w's runs in one copy and counts the
    launch (``_settle``); a fixed-count loop copies them to the host behind
    the launch, without waiting, and counts it once the copy is done: when
    the launch counters are read (``_read_launches``), or at a later
    solve's start.  A capture, build or launch that fails raises; the
    graphs are freed before returning, the pool stays for the next.

    The captured body's nodes are counted by type into the entry
    (``body_nodes``) while the card runs the launch, and its wrappers'
    launches by kernel (``body_launches``).  Within a stamping
    tracer's frame (utils/trace.py::active) the solve opens the spans
    'outer 1', 'capture', 'build' and 'while', and K7w stamps each of its
    runs into a buffer of the tracer's, made before the capture; with no
    tracer K7w gets a null pointer and nothing more is done."""
    _settle_unread(wait=False)
    entry = dict(route="while", outers=0, reads=0, k7w=0, capture_ms=None, instantiate_ms=None,
                 body_nodes=None, body_launches=None)
    tracer = trace.active()
    span = _untraced if tracer is None else tracer.span
    stamps = None if tracer is None or iterations < 2 else tracer.k7w_stamps(iterations + 1,
                                                                             st.go.device)
    if iterations > 0:
        with span("outer 1", entry):
            body()
        entry["outers"] = 1
    if iterations > 1:
        dev = st.go.device
        pool, stream, done = _capture_pool(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = _launch_values()
        t0 = time.perf_counter()
        try:
            with span("capture", entry, device=False), torch.cuda.stream(stream):
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                body()
                graph.capture_end()
            per_body = [a - b for a, b in zip(_launch_values(), before)]
            entry["body_launches"] = {key: n for (*_, key), n in zip(_launch_counters(), per_body)}
        finally:
            _set_launches(before)
        t1 = time.perf_counter()
        try:
            with span("build", entry, device=False):
                handles = cuda_outer.while_build(graph.raw_cuda_graph(), st.go, st.k7w, stamps)
            t2 = time.perf_counter()
            try:
                with span("while", entry, device=False, k7w=stamps):
                    current = torch.cuda.current_stream(dev)
                    current.wait_event(done)
                    cuda_outer.while_launch(handles, dev)
                    entry["body_nodes"] = cuda_outer.graph_nodes(graph.raw_cuda_graph())
                    if read:
                        counts = st.counts.tolist()  # the one host read
                    else:
                        host = torch.empty(5, dtype=torch.int32, pin_memory=True)
                        host.copy_(st.counts, non_blocking=True)
                        copied = torch.cuda.Event()
                        copied.record(current)
                    done.record(current)
            finally:
                cuda_outer.while_free(*handles)
        finally:
            graph.reset()
        entry.update(outers=iterations, reads=int(read), k7w=None, capture_ms=(t1 - t0) * 1e3,
                     instantiate_ms=(t2 - t1) * 1e3)
        if read:
            _settle(entry, per_body, counts)
        else:
            _UNREAD.append((entry, per_body, host, copied))
    loop_log.append(entry)
    return entry["outers"]


def _untraced(*_, **__):
    return contextlib.nullcontext()


def _capture_pool(dev):
    """(pool, stream, done) of every body captured on ``dev``: one memory
    pool and one side stream per device, the pool kept alive by a
    one-kernel graph captured into it, and the event recorded after the
    last WHILE launch.  The caching allocator reuses a freed block only in
    its own pool and on its own stream, and frees a released pool only
    when an allocation outside a capture fails; a fresh pool or stream per
    capture grew the reserved memory by one body's temporaries per solve
    until a capture ran out of the card's memory.  With both shared, a
    body's temporaries reuse the blocks of the bodies before it, so each
    WHILE launch waits for ``done``: the graph before it has finished."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _POOLS:
        pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)
        anchor = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            anchor.capture_begin(pool=pool, capture_error_mode="thread_local")
            torch.zeros(1, device=dev)
            anchor.capture_end()
        _POOLS[key] = (pool, stream, torch.cuda.Event(), anchor)
    return _POOLS[key][:3]


def _release_capture_pool(device=None) -> None:
    """Drop the capture pool and stream of ``device`` (of every device when
    None) once its last WHILE launch has finished, and return the unused
    cached blocks, the pool's among them, to the card
    (``torch.cuda.empty_cache``).  Until then the pool keeps the largest
    body's temporaries reserved, where neither ``empty_cache`` nor an
    allocation that fails can take them back.  For a long-lived process
    between pieces of work (the bench between its cases, the tests); the
    next capture makes a new pool.  A CPU device has none."""
    if device is None:
        keys = list(_POOLS)
    else:
        dev = torch.device(device)
        if dev.type != "cuda":
            return
        keys = [dev.index if dev.index is not None else torch.cuda.current_device()]
    for key in keys:
        if key in _POOLS:
            _, _, done, anchor = _POOLS.pop(key)
            done.synchronize()
            anchor.reset()
    torch.cuda.empty_cache()


def _eager_loop() -> bool:
    """Whether a CUDA solve takes the host loop (``_host_loop``) over the
    WHILE graph: inside ``_eager_outer_loop()``, and while torch's profiler
    runs (autograd's or ``torch.profiler``'s): on torch 2.11 a profiled
    WHILE launch misnames and drops the kernels of the node's bodies, and
    profiled WHILE solves hit an illegal memory access where the same
    solves unprofiled did not (ROADMAP.md section 3, fault E)."""
    return _EAGER_LOOP or torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def _eager_outer_loop():
    """Within the block, every one-image CUDA solve takes the host loop
    (the captured body launched eagerly, outer by outer, one host read of
    the stop state per outer) in place of the WHILE graph: the A/B of
    ``chip_smoke.py`` and the GPU tests.  Not in RLConfig, the CLI or the
    bench."""
    global _EAGER_LOOP
    was, _EAGER_LOOP = _EAGER_LOOP, True
    try:
        yield
    finally:
        _EAGER_LOOP = was


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
