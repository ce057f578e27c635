"""Plain PyTorch reference of blind Richardson-Lucy TV-MM deblurring with its
total-variation terms live: the MM step as Perrone & Favaro publish it and as
the reference project wrote it (lib/deconvolution.pyx:341-675), where the
project's own tree leaves ``TV_ut`` at zero (its calls are commented out at
:464-465, so ``plain.py`` runs the parity step).

Written from the method, not from the program under test: it imports numpy,
torch and the helpers of ``plain.py`` (resize, pyramid, convolutions,
whiteness, gaps, codes), nothing else.  Every array is float32 and every
product runs with TF32 off, unless ``tf32=True`` asks for the control's
precision.

The TV stencil (lib/deconvolution.pyx:137-239): on the 8-neighbour stencil,
order 2, the second differences along the rows, the columns and the two
diagonals (those divided by sqrt(2)); the divergence is minus their sum, the
magnitude the norm of the (rows, columns) pair plus that of the diagonal
pair, both over ``adjust`` (4 (1 + 1/sqrt(2)) for the L1 norm, 2 (1 +
sqrt(2)) for L2); the norms are ε-regularised, |a| + |b| + ε and sqrt(a^2 +
b^2 + ε^2); the border ring is 0.  ε is 1e-2 in blind solves and 1e-6 in
non-blind ones (:434-437).

One outer of ``solve``: the TV magnitudes of ``ut`` (the outer's starting
iterate) in both norms, then five inner steps of: the residual, its
correlation with the PSF, the TV magnitudes of ``u`` in both norms and the
divergence of the L2 call (the reference makes the L1 call first and the L2
call writes the same buffer after it, :495-496), the depth-of-field weights,
the regularisation (:508-519): where both L1 magnitudes are non-zero (live)
``div / TV_u / TV_ut / 2`` for each norm plus ``λ·gradu + (u - ut) / 4``,
elsewhere ``λ·gradu + (u - ut) / 2``; the per-channel step; the TV-denoising
of the observation by the live TV terms alone (:533-549), its own
per-channel step over the observation's maximum, the step divided by λ; the
blend towards the denoised observation, and when blind the PSF step from the
post-update residual.  So the observation is state: each level returns it
denoised, and ``denoised_gap`` compares the program's with this one.

Departures from the published description: the live/dead test reads the L1
magnitudes (``TV_u_L1``, ``TV_ut_L1``); the denoised observation is a
level's own and is not carried to the next level, which resizes the raw
frame again, as the program does; ``tv_norm`` 'channel' only (no channel
coupling; the collaborative norms are the port's additions).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import plain

INNER = plain.INNER
QUALITY_STEP = plain.QUALITY_STEP
COARSE = plain.COARSE
EPSILON = {True: 1e-2, False: 1e-6}  # blind, non-blind (ref lib/deconvolution.pyx:434-437)
ADJUST = {1: 4.0 * (1.0 + 1.0 / np.sqrt(2.0)), 2: 2.0 * (1.0 + np.sqrt(2.0))}
# plain's numbers, with denoised_gap in the place of resize_gap: each blind
# level's returned observation (resized, then TV-denoised by the solve)
# against the reference's own; and two more of each level's output:
# blind_u_gap, u_gap of the blind levels alone, and rms_gap, the
# root-mean-square of the gap over the reference's (the non-blind solves'
# ε of 1e-6 makes a few pixels' TV terms amplify float32 rounding, which
# moves the largest gap and hardly the mean)
NUMBERS = ("denoised_gap", "u_gap", "psf_gap", "stop_gap", "last_stop_gap", "codes_gap",
           "post_gap", "coarse_u_gap", "coarse_stop_gap", "fine_hp_gap", "blind_u_gap",
           "rms_gap")
IMPLEMENTED = plain.IMPLEMENTED + ("use_tv", "tv_norm")
ROUTES = plain.ROUTES
FIXED = dict(plain.FIXED, use_tv=True, tv_norm="channel")
precision = plain.precision


def tv(u: torch.Tensor, epsilon: float, norm: int):
    """(magnitude, divergence) of planar ``u`` (C, H, W), order 2, the
    border ring 0."""
    c = u[:, 1:-1, 1:-1]
    near = lambda di, dj: u[:, 1 + di:u.shape[1] - 1 + di, 1 + dj:u.shape[2] - 1 + dj]
    rows = near(-1, 0) + near(1, 0) - 2.0 * c
    cols = near(0, -1) + near(0, 1) - 2.0 * c
    diag = (near(-1, -1) + near(1, 1) - 2.0 * c) / np.sqrt(2.0)
    anti = (near(-1, 1) + near(1, -1) - 2.0 * c) / np.sqrt(2.0)
    if norm == 1:
        size = lambda a, b: a.abs() + b.abs() + epsilon
    else:
        size = lambda a, b: torch.sqrt(a * a + b * b + epsilon * epsilon)
    mag = (size(rows, cols) + size(diag, anti)) / ADJUST[norm]
    div = -(rows + cols + diag + anti) / ADJUST[norm]
    ring = lambda a: F.pad(a, (1, 1, 1, 1))
    return ring(mag), ring(div)


def solve(image, u, psf, window, *, tau, iterations, step, lambd, blind, outers=None):
    """One level's TV-MM solve on planar float32 ``image`` (C, M, N), ``u``
    (C, M + mk - 1, N + mk - 1) and ``psf`` (C, mk, mk), stopped as
    ``plain.solve`` stops.  Returns dict(u, psf, image, mrs, outers,
    converged): ``u`` the whole window, ``image`` the denoised observation."""
    _, m, n = image.shape
    _, um, un = u.shape
    mk = psf.shape[1]
    pad = (um - m) // 2
    eps = EPSILON[blind]
    weights = plain._whiteness_weights(window[1] - window[0], window[3] - window[2]).to(u.device)
    inner = (slice(None), slice(pad, pad + m), slice(pad, pad + n))
    mrs, hit = [], False
    while (len(mrs) < outers) if outers is not None else (len(mrs) < iterations and not hit):
        ut = u
        ut_l1, ut_l2 = tv(ut, eps, 1)[0], tv(ut, eps, 2)[0]
        for _ in range(INNER):
            err = plain._conv_valid(u, psf) - image
            grad = plain._conv_full(err, torch.flip(psf, (1, 2)))
            u_l1 = tv(u, eps, 1)[0]
            u_l2, div = tv(u, eps, 2)
            g = grad[inner]
            dof = ((g - image) / (g + image)) ** 2
            if not blind:
                dof = dof / lambd
            live = (ut_l1 != 0.0) & (u_l1 != 0.0)
            terms = div / u_l1 / ut_l1 / 2.0 + div / u_l2 / ut_l2 / 2.0
            reg = torch.where(live, terms + lambd * grad + (u - ut) / 4.0,
                              lambd * grad + (u - ut) / 2.0)
            dt = step * (u.amax(dim=(1, 2)) + 1.0 / (um * un)) / (
                reg.abs().amax(dim=(1, 2)) + 1e-15)
            u = u - dt[:, None, None] * reg
            denoise = torch.where(live, terms, 0.0)
            dti = step * (image.amax(dim=(1, 2)) + 1.0 / (m * n)) / (
                denoise.abs().amax(dim=(1, 2)) + 1e-15)
            image = image - dti[:, None, None] * denoise[inner] / lambd
            u[inner] = (1.0 - dof) * u[inner] + dof * image
            if blind:
                err = plain._conv_valid(u, psf) - image
                gk = plain._psf_grad(u, err)
                dtp = step / mk * (psf.max() + 1.0 / (um * un * 3)) / (gk.abs().max() + 1e-15)
                psf = torch.clamp(psf - dtp * gk, min=0.0)
                psf = psf / psf.sum(dim=(1, 2), keepdim=True)
        mrs.append(plain.whiteness(err, window, weights))
        if len(mrs) >= 3:
            hit = plain._change(mrs[-1], mrs[-2]) > (0.0 if blind else tau)
    return dict(u=u, psf=psf, image=image, mrs=mrs, outers=len(mrs), converged=hit)


def _guard(kw: dict) -> None:
    """Refuse, by name, every kwarg whose maths this reference lacks."""
    for key, value in kw.items():
        if key in FIXED:
            if value != FIXED[key]:
                raise ValueError(f"the reference runs {key}={FIXED[key]!r}, not {value!r}")
        elif key not in IMPLEMENTED and key not in ROUTES:
            raise ValueError(f"the reference does not implement the kwarg {key}={value!r}")


def run(raw: np.ndarray, kw: dict, device, *, follow=None, tf32=False, program_codes=None,
        detail: list | None = None):
    """``plain.run`` with the TV terms live (``use_tv=True``, ``tv_norm``
    'channel'): the whole frame ``raw`` deblurred with ``deblur_module``'s
    kwargs ``kw``; without ``follow`` (codes, records), with ``follow`` and
    ``program_codes`` the numbers of ``NUMBERS``.  A blind level's record
    holds its denoised observation under ``image``."""
    with precision(tf32), torch.no_grad():
        return _run(raw, kw, torch.device(device), follow, program_codes, detail)


def _rms_gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    """The root-mean-square of the gap over the reference's, in float64."""
    d = (a.to(ref.device, torch.float32) - ref).double()
    return float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(ref.double()))


def _box(top, bottom, left, right, scale):
    """The mask box at ``scale``, with deconvolve.py:209-230's odd-size
    fix-ups (its second test compares a value with itself)."""
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
    return tt, tb, tl, tr


def _run(raw, kw, dev, follow, program_codes, detail):
    _guard(kw)
    bits = kw.get("bits", 8)
    stored = plain.stored_psf(kw["psf_path"]) if kw.get("psf_path") is not None else None
    blur = kw["blur_width"] if stored is None else stored.shape[0]
    mask_size = kw.get("mask_size", 255)
    iterations = kw.get("iterations", 200)
    step = QUALITY_STEP[kw.get("quality", "normal")]
    tolerance = kw.get("tolerance", 1.0) / 100.0
    lambd = kw.get("confidence", 10) * 1000.0
    edge = plain._edge

    pic = torch.from_numpy(np.ascontiguousarray(raw)).to(dev).float()
    pic = edge(pic, 1, 1, 1, 1)
    pic = (pic / (2**bits - 1)) ** (1 / 2.2)
    rows, cols = pic.shape[:2]  # the level sizes follow the size before the odd-size pad
    centre = kw.get("mask") or [rows // 2, cols // 2]
    top, bottom = centre[0] - mask_size // 2, centre[0] + mask_size // 2
    left, right = centre[1] - mask_size // 2, centre[1] + mask_size // 2
    odd_rows, odd_cols = rows % 2 == 0, cols % 2 == 0
    pic = edge(pic, int(odd_rows), 0, int(odd_cols), 0)

    if stored is None:
        psf = torch.full((blur, blur, 3), 1.0 / blur**2, dtype=torch.float32, device=dev)
    else:  # a stored PSF: the blind phase is skipped
        psf = torch.from_numpy(stored).to(dev)
    scales, sizes = plain.pyramid(blur)
    numbers = dict.fromkeys(NUMBERS, 0.0)
    records, li, last = [], 0, None
    for case in ("blind", "non-blind") if stored is None else ("non-blind",):
        blind = case == "blind"
        deblured = pic
        for scale, k in zip(reversed(scales), reversed(sizes)):
            tt, tb, tl, tr = _box(top, bottom, left, right, scale)
            tw, th = int(np.floor(scale * cols)), int(np.floor(scale * rows))
            tw += tw % 2 == 0
            th += th % 2 == 0
            image = edge(plain.resize(pic, th, tw), 1, 1, 1, 1)
            deblured = edge(plain.resize(deblured, th, tw), 1, 1, 1, 1)
            if blind:
                kpsf = plain._normalize(plain.resize(psf, k, k))
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
                img, start = image[tt - 1:tb + 1, tl - 1:tr + 1], deblured[box]
            else:
                deblured = edge(deblured, pad, pad, pad, pad)
                img, start = image, deblured
            out = solve(plain._planar(img), plain._planar(start), plain._planar(kpsf), window,
                        tau=tau, iterations=iterations, step=step, lambd=lambd, blind=blind,
                        outers=None if rec is None else rec["outers"])
            u = plain._hwc(out["u"])
            if not blind:
                u = u[pad:pad + th + 2, pad:pad + tw + 2]
            own = dict(case=case, scale=scale, outers=out["outers"],
                       converged=out["converged"], m_r=out["mrs"][-1], u=u,
                       psf=plain._hwc(out["psf"]) if blind else None,
                       image=plain._hwc(out["image"]) if blind else None)
            if rec is not None:
                stop = "last_stop_gap" if li == len(follow) - 1 else "stop_gap"
                level = {"u_gap": plain._gap(rec["u"], u), "rms_gap": _rms_gap(rec["u"], u),
                         stop: plain._stop_gap(rec, out["mrs"], tau, iterations)}
                if blind:
                    level.update(blind_u_gap=level["u_gap"],
                                 denoised_gap=plain._gap(rec["image"], own["image"]),
                                 psf_gap=plain._gap(rec["psf"], own["psf"]))
                if scale <= COARSE:
                    level.update(coarse_u_gap=level["u_gap"], coarse_stop_gap=level[stop])
                else:
                    level.update(fine_hp_gap=plain._high_pass_gap(rec["u"], u))
                for key, value in level.items():
                    numbers[key] = max(numbers[key], value)
                if detail is not None:
                    detail.append(dict(case=case, scale=scale, outers=rec["outers"],
                                       m_r=[rec["m_r"], out["mrs"][-1]], **level,
                                       decision_gap=plain._decision_gap(rec, out["mrs"], tau,
                                                                        iterations),
                                       u=plain._where(rec["u"], u)))
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
    frame = plain.codes(last, odd_rows, odd_cols)
    if follow is None:
        return frame, records
    got = np.asarray(program_codes)
    post = plain.codes(follow[-1]["u"].to(dev), odd_rows, odd_cols)
    if got.shape != frame.shape or got.shape != post.shape:
        numbers["codes_gap"] = numbers["post_gap"] = float("inf")
    else:
        numbers["post_gap"] = float(np.abs(got.astype(np.int64) - post).max())
        numbers["codes_gap"] = float(np.abs(got.astype(np.int64) - frame).max())
    return numbers
