"""Plain PyTorch reference of blind Richardson-Lucy TV-MM deblurring, as the
reference project's deconvolve.py runs it (parity mode: the TV buffers stay
zero, so the regulariser is ``lambd * gradu + (u - ut) / 2``).

Written from the method, not from the program under test: it imports numpy
and torch only.  Every array is float32 and every product runs with TF32
off, unless ``tf32=True`` asks for the control's precision.  Convolutions
are cuDNN's grouped ``conv2d``, the cubic resize is ``jax.image.resize``'s
(Keys a = -0.5, antialiased on downscale, weights renormalised) as dense
matrices, and the residual-whiteness metric is computed in float64.

``run`` drives the whole frame: preprocessing, the sqrt(2) pyramid, the
blind mask-window solves that estimate the PSF (or a stored PSF read from
its file, in their place), the non-blind full-frame solves and the 16-bit
codes.  With ``follow`` (the program's per-level
records) each level runs as many outers as the program ran there, and
nothing else of the program's: every level starts from the reference's own
previous level and PSF, and its output is compared with the program's
output of that level, the codes with the program's codes.  The whiteness
stop is chaotic in the last bits, so a reference that made its own stops
would stop at other outers and drift away; the numbers ``run`` returns in
that mode say how far the program is from the reference at every level
and in the codes, and whether each stop the program made agrees with the
reference's whiteness trajectory over the same outers.  The postprocess is
also checked by itself, on the program's own last level, where it is exact.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

INNER = 5  # inner iterations per outer (ref lib/deconvolution.pyx:375)
QUALITY_STEP = {"normal": 1e-3, "high": 5e-4, "veryhigh": 1e-4, "low": 5e-3}
# resize_gap: the observed blind windows (preprocess and cubic resize); u_gap,
# psf_gap: each level's output and each blind level's PSF; stop_gap: the stops
# of every level but the last, last_stop_gap: the last level's; codes_gap: the
# 16-bit frame; post_gap: the program's codes against this postprocess of the
# program's own last level (exact); coarse_u_gap, coarse_stop_gap: u_gap and
# stop_gap of the levels at scale COARSE or below alone, which come before the
# larger levels' solves amplify rounding; fine_hp_gap: of each level above
# COARSE, the root-mean-square of its gap less the gap's box mean over
# HIGH_PASS x HIGH_PASS pixels, over the reference's (the rounding that those
# levels amplify moves the frame's lowest frequencies, which the mean takes out)
NUMBERS = ("resize_gap", "u_gap", "psf_gap", "stop_gap", "last_stop_gap", "codes_gap",
           "post_gap", "coarse_u_gap", "coarse_stop_gap", "fine_hp_gap")
COARSE = 0.5
HIGH_PASS = 3
# deblur_module's kwargs that this reference implements
IMPLEMENTED = ("blur_width", "confidence", "tolerance", "quality", "bits", "mask", "mask_size",
               "iterations", "psf_path")
# kwargs that choose a route or an output and leave the maths as they are
ROUTES = ("display", "inner_loop", "save_psf_path")
# kwargs that change the maths, each at the one value this reference runs (p, norm,
# order and priority are the port's vestigial RLConfig fields, held all the same);
# any other kwarg, resize_backend among them, is refused whatever its value
FIXED = {"solver": "mm", "precision": "exact", "blur": "static", "preview": False,
         "use_tv": False, "tv_norm": "channel", "nonblind_levels": "all", "blind_budget": None,
         "early_stop": 0.0, "refocus": False, "config": None, "p": 1, "norm": 1, "order": 2,
         "priority": 0}


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products with TF32 off (the configuration's precision), or
    on (the control's), with cuDNN timing its algorithms for each shape
    (a 24 MP frame's check takes 25 s so, 35 s on its heuristics); the
    flags are restored on exit."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = cuda.allow_tf32, cudnn.allow_tf32, cudnn.benchmark
    cuda.allow_tf32 = cudnn.allow_tf32 = tf32
    cudnn.benchmark = True
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32, cudnn.benchmark = was


def _edge(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Edge-replicate padding of an (H, W, C) array."""
    y = F.pad(x.permute(2, 0, 1)[None], (left, right, top, bottom), mode="replicate")
    return y[0].permute(1, 2, 0).contiguous()


def _planar(x: torch.Tensor) -> torch.Tensor:
    return x.permute(2, 0, 1).contiguous()


def _hwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(1, 2, 0).contiguous()


def pyramid(psf_size: int):
    """Scales shrinking by sqrt(2) and PSF sizes ceil(k / sqrt(2)), forced odd
    and at least 3 (deconvolve.py:40-60)."""
    scales, sizes = [1.0], [psf_size]
    while sizes[-1] > 3:
        size = int(np.ceil(sizes[-1] / np.sqrt(2)))
        size -= size % 2 == 0
        sizes.append(max(size, 3))
        scales.append(scales[-1] / np.sqrt(2))
    return scales, sizes


def _keys(x: np.ndarray) -> np.ndarray:
    """The Keys cubic, a = -0.5, of |x|."""
    return np.where(x < 1.0, (1.5 * x - 2.5) * x * x + 1.0,
                    np.where(x < 2.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, 0.0))


_WEIGHTS: dict = {}


def _weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) float32 weights of one resized axis: the cubic at
    half-pixel centres, widened by the scale on downscale, each output's
    weights renormalised to sum 1, outputs sampled outside the input 0."""
    key = (n_in, n_out, str(device))
    if key not in _WEIGHTS:
        step = n_in / n_out
        at = (np.arange(n_out) + 0.5) * step - 0.5
        x = np.abs(at[None, :] - np.arange(n_in)[:, None]) / max(step, 1.0)
        w = _keys(x)
        total = w.sum(axis=0, keepdims=True)
        ok = np.abs(total) > 1000.0 * np.finfo(np.float32).eps
        w = np.where(ok, w / np.where(total != 0.0, total, 1.0), 0.0)
        w *= ((at >= -0.5) & (at <= n_in - 0.5))[None, :]
        _WEIGHTS[key] = torch.from_numpy(w.astype(np.float32)).to(device)
    return _WEIGHTS[key]


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Cubic resize of (H, W, C) to (h, w, C); an axis of unchanged size is
    left as it is."""
    if x.shape[0] != h:
        x = (_weights(x.shape[0], h, x.device).T @ x.reshape(x.shape[0], -1)).reshape(
            h, *x.shape[1:])
    if x.shape[1] != w:
        x = (x.movedim(1, -1) @ _weights(x.shape[1], w, x.device)).movedim(-1, 1)
    return x.contiguous()


def _normalize(psf: torch.Tensor) -> torch.Tensor:
    """Clamp negative taps to 0 and make each channel sum to 1."""
    psf = torch.clamp(psf, min=0.0)
    return psf / psf.sum(dim=(0, 1), keepdim=True)


def _conv_valid(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """scipy.signal.convolve(a[c], k[c], 'valid') of planar (C, H, W)."""
    return F.conv2d(a[None], torch.flip(k, (1, 2))[:, None], groups=a.shape[0])[0]


def _conv_full(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """scipy.signal.convolve(a[c], k[c], 'full') of planar (C, H, W)."""
    p, q = k.shape[1] - 1, k.shape[2] - 1
    return _conv_valid(F.pad(a, (q, q, p, p)), k)


def _psf_grad(u: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """convolve(rot180(u[c]), err[c], 'valid'): the PSF gradient, the
    flipped cross-correlation of u with the residual."""
    return torch.flip(F.conv2d(u[None], err[:, None], groups=u.shape[0])[0], (1, 2))


def _whiteness_weights(h: int, w: int) -> torch.Tensor:
    """sqrt(outer(pdf(linspace(-1, 1, h)), pdf(linspace(-1, 1, w)))) of the
    normal pdf, summing to 1, as float32 (ref lib/deconvolution.pyx:392-404)."""
    pdf = lambda n: np.exp(-np.linspace(-1.0, 1.0, n) ** 2 / 2.0) / np.sqrt(2.0 * np.pi)
    ww = np.sqrt(np.outer(pdf(h), pdf(w)))
    return torch.from_numpy((ww / ww.sum()).astype(np.float32))


def whiteness(err: torch.Tensor, window, weights: torch.Tensor) -> float:
    """M_r, the residual-whiteness metric over ``window`` (top, bottom,
    left, right) of the planar residual, in float64: the standardised patch
    scaled to a largest magnitude of 1, its autocorrelation (scipy
    'same'), squared, weighted and averaged."""
    top, bottom, left, right = window
    t = err[:, top:bottom, left:right].double()
    t = (t - t.mean()) / t.std(correction=0)
    t = t / t.abs().max()
    _, h, w = t.shape
    s = (2 * h - 1, 2 * w - 1)
    full = torch.fft.irfft2(torch.fft.rfft2(t, s=s) * torch.fft.rfft2(torch.flip(t, (1, 2)), s=s),
                            s=s)
    oy, ox = (h - 1) // 2, (w - 1) // 2
    ac = full[:, oy:oy + h, ox:ox + w]
    return float(torch.mean(ac * ac * weights.to(ac)))


def solve(image, u, psf, window, *, tau, iterations, step, lambd, blind, outers=None):
    """One level's solve on planar float32 ``image`` (C, M, N), ``u`` (C,
    M + mk - 1, N + mk - 1) and ``psf`` (C, mk, mk): outers of five inner
    iterations (residual, its correlation with the PSF, depth-of-field
    weights, the regularised step, the blend, and when ``blind`` the PSF
    step), each followed by M_r of the last residual.  Stops where the
    whiteness test fires from the third outer on, or after ``iterations``;
    with ``outers`` it runs exactly that many.  Returns dict(u, psf, mrs,
    outers, converged) with ``u`` the whole window."""
    _, m, n = image.shape
    _, um, un = u.shape
    mk = psf.shape[1]
    pad = (um - m) // 2
    weights = _whiteness_weights(window[1] - window[0], window[3] - window[2]).to(u.device)
    inner = (slice(None), slice(pad, pad + m), slice(pad, pad + n))
    mrs, hit = [], False
    while (len(mrs) < outers) if outers is not None else (len(mrs) < iterations and not hit):
        ut = u
        for _ in range(INNER):
            err = _conv_valid(u, psf) - image
            grad = _conv_full(err, torch.flip(psf, (1, 2)))
            g = grad[inner]
            dof = ((g - image) / (g + image)) ** 2
            if not blind:
                dof = dof / lambd
            reg = lambd * grad + (u - ut) / 2.0
            dt = step * (u.amax(dim=(1, 2)) + 1.0 / (um * un)) / (
                reg.abs().amax(dim=(1, 2)) + 1e-15)
            u = u - dt[:, None, None] * reg
            u[inner] = (1.0 - dof) * u[inner] + dof * image
            if blind:
                err = _conv_valid(u, psf) - image
                gk = _psf_grad(u, err)
                dtp = step / mk * (psf.max() + 1.0 / (um * un * 3)) / (gk.abs().max() + 1e-15)
                psf = torch.clamp(psf - dtp * gk, min=0.0)
                psf = psf / psf.sum(dim=(1, 2), keepdim=True)
        mrs.append(whiteness(err, window, weights))
        if len(mrs) >= 3:
            hit = _change(mrs[-1], mrs[-2]) > (0.0 if blind else tau)
    return dict(u=u, psf=psf, mrs=mrs, outers=len(mrs), converged=hit)


def _change(new: float, prev: float) -> float:
    """The relative change of M_r that the stop compares with its threshold;
    for the blind test (new > prev) the threshold is 0."""
    return (new - prev) / (new + prev)


def _gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest absolute difference over the reference's largest magnitude."""
    a = a.to(ref.device, torch.float32)
    return float((a - ref).abs().max() / ref.abs().max())


def _box(x: torch.Tensor, width: int) -> torch.Tensor:
    """The mean of (H, W, C) ``x`` over a ``width`` x ``width`` box around
    each pixel, edges replicated."""
    r = width // 2
    y = F.pad(x.permute(2, 0, 1)[None], (r, r, r, r), mode="replicate")[0]
    for axis in (1, 2):
        c = F.pad(torch.cumsum(y, axis), (1, 0) if axis == 2 else (0, 0, 1, 0))
        y = (c.narrow(axis, width, c.shape[axis] - width)
             - c.narrow(axis, 0, c.shape[axis] - width)) / width
    return y.permute(1, 2, 0)


def _high_pass_gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    """The root-mean-square of the gap less its box mean (``HIGH_PASS``),
    over the reference's, in float64."""
    d = (a.to(ref.device, torch.float32) - ref).double()
    d = d - _box(d, HIGH_PASS)
    return float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(ref.double()))


def _stop_gap(rec: dict, mrs: list, tau: float, iterations: int) -> float:
    """How far the program's stop at this level disagrees with the
    reference's whiteness trajectory over the same outers, in units of the
    relative change of M_r: the program's last M_r against the reference's,
    every outer it went on past a change above the threshold, and its stop
    where the change did not pass it.  0 where they agree."""
    return max(abs(rec["m_r"] - mrs[-1]) / abs(mrs[-1]), _decision_gap(rec, mrs, tau, iterations))


def _decision_gap(rec: dict, mrs: list, tau: float, iterations: int) -> float:
    """``_stop_gap`` without the last M_r: the stop decisions alone."""
    gap = 0.0
    for k in range(2, len(mrs)):
        change = _change(mrs[k], mrs[k - 1])
        stopped = k == len(mrs) - 1 and rec["converged"]
        gap = max(gap, tau - change if stopped else change - tau)
    if not rec["converged"] and rec["outers"] != iterations:
        gap = max(gap, 1.0)  # stopped without the test firing
    return max(gap, 0.0)


def codes(u: torch.Tensor, odd_rows: bool, odd_cols: bool) -> np.ndarray:
    """The last level's (H, W, C) iterate, safety ring included, to the
    16-bit frame (ref deconvolve.py:346-352): strip the ring, clip to [0, 1],
    gamma 2.2, scale to 65535 and truncate; then drop the odd-size padding
    and the preprocessing's one-pixel ring."""
    u = u[1:-1, 1:-1]
    out = (torch.clamp(u, 0.0, 1.0) ** 2.2 * 65535.0).to(torch.int32).cpu().numpy()
    out = out.astype(np.uint16)
    if odd_cols:
        out = out[:, 1:]
    if odd_rows:
        out = out[1:]
    return out[1:-1, 1:-1]


def run(raw: np.ndarray, kw: dict, device, *, follow=None, tf32=False, program_codes=None,
        detail: list | None = None):
    """The whole frame ``raw`` (H, W, 3 integers) deblurred with
    ``deblur_module``'s kwargs ``kw`` (blur_width, mask, mask_size,
    tolerance, quality, iterations, confidence, bits; blind, static blur;
    with ``psf_path`` the stored PSF of that checkpoint file, its width the
    blur's, and the non-blind levels only).  A kwarg whose maths it lacks
    raises a ``ValueError`` that names it (``IMPLEMENTED``, ``ROUTES``,
    ``FIXED``).

    Without ``follow``: returns (codes, records), the reference's own run,
    one record per level (case, scale, outers, converged, m_r, u: the
    blind window or the non-blind frame, psf, image), (H, W, C) tensors.
    With ``follow`` (the program's records, in that form) and
    ``program_codes``: returns the numbers of ``NUMBERS``, each the largest
    over the levels; ``detail`` then receives each level's numbers, and
    for the readings the root-mean-square gap of ``u`` and where and how
    large its largest gap is."""
    with precision(tf32), torch.no_grad():
        return _run(raw, kw, torch.device(device), follow, program_codes, detail)


def _where(a: torch.Tensor, ref: torch.Tensor) -> dict:
    """The root-mean-square gap over the reference's, and the largest gap's
    place (row, column, channel) with both values there."""
    a = a.to(ref.device, torch.float32)
    d = (a - ref).abs()
    at = np.unravel_index(int(d.argmax()), d.shape)
    return dict(rms=float(torch.linalg.vector_norm(a - ref) / torch.linalg.vector_norm(ref)),
                at=[int(x) for x in at], program=float(a[at]), reference=float(ref[at]))


def _guard(kw: dict) -> None:
    """Refuse, by name, every kwarg whose maths this reference lacks."""
    for key, value in kw.items():
        if key in FIXED:
            if value != FIXED[key]:
                raise ValueError(f"the reference runs {key}={FIXED[key]!r}, not {value!r}")
        elif key not in IMPLEMENTED and key not in ROUTES:
            raise ValueError(f"the reference does not implement the kwarg {key}={value!r}")


def stored_psf(path) -> np.ndarray:
    """The (k, k, 3) float32 PSF of a checkpoint file (key ``psf``)."""
    with np.load(path, allow_pickle=False) as z:
        psf = np.asarray(z["psf"], np.float32)
    if psf.ndim != 3 or psf.shape[0] != psf.shape[1] or psf.shape[2] != 3:
        raise ValueError(f"stored PSF has shape {psf.shape}; expected (k, k, 3)")
    return psf


def _run(raw, kw, dev, follow, program_codes, detail):
    _guard(kw)
    bits = kw.get("bits", 8)
    stored = stored_psf(kw["psf_path"]) if kw.get("psf_path") is not None else None
    blur = kw["blur_width"] if stored is None else stored.shape[0]
    mask_size = kw.get("mask_size", 255)
    iterations = kw.get("iterations", 200)
    step = QUALITY_STEP[kw.get("quality", "normal")]
    tolerance = kw.get("tolerance", 1.0) / 100.0
    lambd = kw.get("confidence", 10) * 1000.0

    pic = torch.from_numpy(np.ascontiguousarray(raw)).to(dev).float()
    pic = _edge(pic, 1, 1, 1, 1)
    pic = (pic / (2**bits - 1)) ** (1 / 2.2)
    # the level sizes follow the frame's size before the odd-size padding
    rows, cols = pic.shape[:2]
    centre = kw.get("mask") or [rows // 2, cols // 2]
    top, bottom = centre[0] - mask_size // 2, centre[0] + mask_size // 2
    left, right = centre[1] - mask_size // 2, centre[1] + mask_size // 2
    odd_rows, odd_cols = rows % 2 == 0, cols % 2 == 0
    pic = _edge(pic, int(odd_rows), 0, int(odd_cols), 0)

    if stored is None:
        psf = torch.full((blur, blur, 3), 1.0 / blur**2, dtype=torch.float32, device=dev)
    else:  # a stored PSF: the blind phase is skipped
        psf = torch.from_numpy(stored).to(dev)
    scales, sizes = pyramid(blur)
    numbers = dict.fromkeys(NUMBERS, 0.0)
    records, li, last = [], 0, None
    for case in ("blind", "non-blind") if stored is None else ("non-blind",):
        blind = case == "blind"
        deblured = pic
        for scale, k in zip(reversed(scales), reversed(sizes)):
            # the mask box at this scale, its odd-size fix-ups as deconvolve.py
            # :209-230 has them (the second test compares a value with itself)
            tt, tb, tl, tr = (int(scale * v) for v in (top, bottom, left, right))
            if (tb - tt) % 2 == 0:
                if tb - tt < tr - tl:
                    tb += 1
                elif tb - tt > tr - tl:
                    tt += 1
                else:
                    tt -= 1
            if (tr - tl) % 2 == 0:
                if tb - tt < tr - tl:
                    tl += 1
                else:
                    tr += 1
            tw, th = int(np.floor(scale * cols)), int(np.floor(scale * rows))
            tw += tw % 2 == 0
            th += th % 2 == 0
            image = _edge(resize(pic, th, tw), 1, 1, 1, 1)
            deblured = _edge(resize(deblured, th, tw), 1, 1, 1, 1)
            if blind:
                kpsf = _normalize(resize(psf, k, k))
            else:
                kpsf, k = psf, sizes[0]
            pad = k // 2
            window = (pad + 1, tb - tt - pad - 1, pad + 1, tb - tt - pad - 1)
            tau = 0.0 if blind else (tolerance if scale == 1.0 else 0.0)
            rec = follow[li] if follow is not None else None
            if rec is not None and (rec["case"], rec["scale"]) != (case, scale):
                raise ValueError(f"level {li}: the program ran {rec['case']} at "
                                 f"{rec['scale']}, the reference {case} at {scale}")
            if blind:
                box = (slice(tt - pad - 1, tb + pad + 1), slice(tl - pad - 1, tr + pad + 1))
                img = image[tt - 1:tb + 1, tl - 1:tr + 1]
                start = deblured[box]
            else:
                deblured = _edge(deblured, pad, pad, pad, pad)
                img, start = image, deblured
            out = solve(_planar(img), _planar(start), _planar(kpsf), window, tau=tau,
                        iterations=iterations, step=step, lambd=lambd, blind=blind,
                        outers=None if rec is None else rec["outers"])
            u = _hwc(out["u"])
            if not blind:
                u = u[pad:pad + th + 2, pad:pad + tw + 2]
            own = dict(case=case, scale=scale, outers=out["outers"],
                       converged=out["converged"], m_r=out["mrs"][-1], u=u,
                       psf=_hwc(out["psf"]) if blind else None, image=img if blind else None)
            if rec is not None:
                stop = "last_stop_gap" if li == len(follow) - 1 else "stop_gap"
                level = {"u_gap": _gap(rec["u"], u),
                         stop: _stop_gap(rec, out["mrs"], tau, iterations)}
                if blind:
                    level.update(resize_gap=_gap(rec["image"], img),
                                 psf_gap=_gap(rec["psf"], own["psf"]))
                if scale <= COARSE:
                    level.update(coarse_u_gap=level["u_gap"], coarse_stop_gap=level[stop])
                else:
                    level.update(fine_hp_gap=_high_pass_gap(rec["u"], u))
                for key, value in level.items():
                    numbers[key] = max(numbers[key], value)
                if detail is not None:
                    detail.append(dict(case=case, scale=scale, outers=rec["outers"],
                                       m_r=[rec["m_r"], out["mrs"][-1]], **level,
                                       decision_gap=_decision_gap(rec, out["mrs"], tau,
                                                                  iterations),
                                       u=_where(rec["u"], u)))
            else:
                records.append(own)
            last = u
            if blind:
                deblured = deblured.clone()
                deblured[box] = own["u"]
                psf = own["psf"]
            else:
                deblured = own["u"]
            deblured = deblured[1:-1, 1:-1]
            li += 1
    if follow is not None and li != len(follow):
        raise ValueError(f"the program ran {len(follow)} levels, the reference {li}")
    frame = codes(last, odd_rows, odd_cols)
    if follow is None:
        return frame, records
    got = np.asarray(program_codes)
    post = codes(follow[-1]["u"].to(dev), odd_rows, odd_cols)
    if got.shape != frame.shape or got.shape != post.shape:
        numbers["codes_gap"] = numbers["post_gap"] = float("inf")
    else:
        numbers["post_gap"] = float(np.abs(got.astype(np.int64) - post).max())
        diff = np.abs(got.astype(np.int64) - frame)
        numbers["codes_gap"] = float(diff.max())
        if detail is not None:
            detail.append(dict(codes_rms=float(np.sqrt(np.mean(diff.astype(np.float64) ** 2))),
                               codes_p99=float(np.percentile(diff, 99)),
                               codes_p999=float(np.percentile(diff, 99.9)),
                               codes_over_2=int((diff > 2).sum()), codes_max=int(diff.max())))
    return numbers
