"""Colour and tone operators (counterpart of ics_tpu/utils/color.py; parity
targets: reference lib/utils.py:45-131 and 319-417, and the HSV prototypes of
``notebooks/HSV color balance.ipynb``), as torch functions on the input's
device; no kernel is involved.

The 3x3 colour matrices of the LAB conversions are float32 ``einsum``s with
TF32 off, as the JAX package computes them in float32.  A tensor input stays
on its own device; every other input becomes a float32 tensor on the
operator's ``device`` argument (``'cuda'`` unless the caller asks for the
CPU, raising without a GPU).  ``Lagrange_interpolation`` is host NumPy, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ics_tpu_torch._device import exact_f32, resolve_device, to_f32

__all__ = [
    "Lagrange_interpolation",
    "LABImage",
    "grey_point",
    "auto_vibrance",
    "divTV",
    "gradTVEM",
    "rgb_to_hsv",
    "hsv_to_rgb",
    "rgb_to_lab",
    "lab_to_rgb",
    "normal2rad",
    "rad2normal",
    "hue_shift",
    "saturation_boost",
    "luma_masks",
]

# D65 white point, sRGB primaries (IEC 61966-2-1)
_XYZ_FROM_RGB = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ]
)
_RGB_FROM_XYZ = np.linalg.inv(_XYZ_FROM_RGB)
_WHITE_D65 = np.array([0.95047, 1.0, 1.08883])


@dataclasses.dataclass
class LABImage:
    """LAB container with the attribute surface the reference's colour ops
    expect (``src.L``, ``src.A``, ``src.B``)."""

    L: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor


def _const(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def _srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c):
    return torch.where(
        c <= 0.0031308, c * 12.92, 1.055 * torch.clamp(c, min=1e-12) ** (1 / 2.4) - 0.055
    )


def _lab_f(t):
    d = 6.0 / 29.0
    # cube root of the branch that is taken (t > d^3 > 0)
    return torch.where(t > d**3, torch.clamp(t, min=d**3) ** (1.0 / 3.0),
                       t / (3 * d * d) + 4.0 / 29.0)


def _lab_f_inv(t):
    d = 6.0 / 29.0
    return torch.where(t > d, t**3, 3 * d * d * (t - 4.0 / 29.0))


def rgb_to_lab(rgb: torch.Tensor) -> LABImage:
    """sRGB [0,1] (..., 3) float32 tensor -> CIELAB (L in [0,100])."""
    exact_f32()
    lin = _srgb_to_linear(rgb)
    xyz = torch.einsum("ij,...j->...i", _const(_XYZ_FROM_RGB, lin), lin)
    xyz = xyz / _const(_WHITE_D65, lin)
    f = _lab_f(xyz)
    l = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return LABImage(L=l, A=a, B=b)


def lab_to_rgb(lab: LABImage) -> torch.Tensor:
    """CIELAB -> sRGB [0,1] (..., 3), clipped to gamut."""
    exact_f32()
    l, a, b = lab.L, lab.A, lab.B
    fy = (l + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    xyz = torch.stack([_lab_f_inv(fx), _lab_f_inv(fy), _lab_f_inv(fz)], dim=-1)
    xyz = xyz * _const(_WHITE_D65, xyz)
    lin = torch.einsum("ij,...j->...i", _const(_RGB_FROM_XYZ, xyz), xyz)
    return torch.clamp(_linear_to_srgb(lin), 0.0, 1.0)


def _f32(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor: a tensor stays on its device, anything
    else goes to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return to_f32(x, resolve_device(device))


def Lagrange_interpolation(points: np.ndarray, variable=None):
    """Lagrange interpolation polynomial through n points, host NumPy (copied
    from ics_tpu/utils/color.py:104-124).

    Returns ``(P, Y)`` like the reference (lib/utils.py:45-82): ``P`` is the
    polynomial (an ``np.poly1d`` instead of a sympy expression) and ``Y`` its
    evaluation at ``variable`` (or None if no variable is given).
    """
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    poly = np.poly1d([0.0])
    for i in range(n):
        xi, yi = points[i]
        term = np.poly1d([yi])
        for j in range(n):
            if j == i:
                continue
            xj = points[j, 0]
            term = term * np.poly1d([1.0, -xj]) / (xi - xj)
        poly = poly + term
    Y = None if variable is None else poly(np.asarray(variable))
    return poly, Y


def _lagrange3_eval(xs, ys, x: torch.Tensor) -> torch.Tensor:
    """The quadratic through three (x, y) points, evaluated at ``x``;
    ``xs`` entries may be 0-d tensors."""
    total = torch.zeros_like(x)
    for i in range(3):
        term = torch.ones_like(x) * ys[i]
        for j in range(3):
            if j != i:
                term = term * (x - xs[j]) / (xs[i] - xs[j])
        total = total + term
    return total


def grey_point(src: LABImage, amount: float, device="cuda") -> LABImage:
    """Shift the grey point via the ratio of two Lagrange curves on L
    (parity: ref lib/utils.py:85-113)."""
    L = _f32(src.L, device)
    y1 = _lagrange3_eval([0.0, amount, 100.0], [1.0, amount, 100.0], L)
    y2 = _lagrange3_eval([0.0, torch.mean(L), 100.0], [1.0, amount, 100.0], L)
    ratio = y2 / y1
    return LABImage(L=L * ratio, A=_f32(src.A, L.device) * ratio, B=_f32(src.B, L.device) * ratio)


# auto_vibrance's two smoothing splines are fixed curves (constant data, ref
# lib/utils.py:116-131): fitted once on the host, evaluated on the device
_VIBRANCE_X = np.array([-100, -50, -20, 0, 20, 50, 100], dtype=np.float64)
_VIBRANCE_Y1 = np.array([100, 45, 19, 1, 19, 45, 100], dtype=np.float64)
_VIBRANCE_Y2 = np.array([100, 50, 20, 1, 20, 50, 100], dtype=np.float64)


@functools.lru_cache(maxsize=1)
def _vibrance_ppolys():
    """(breaks, coefficients) of each spline: FITPACK's smoothing fit
    (``splrep``, s = len(x), UnivariateSpline's default) as a ``PPoly``."""
    from scipy import interpolate

    pps = []
    for y in (_VIBRANCE_Y1, _VIBRANCE_Y2):
        tck = interpolate.splrep(_VIBRANCE_X, y, s=len(_VIBRANCE_X))
        pp = interpolate.PPoly.from_spline(tck)
        pps.append((np.asarray(pp.x), np.asarray(pp.c)))
    return tuple(pps)


def _ppoly_eval(breaks, coefs, x: torch.Tensor) -> torch.Tensor:
    """Piecewise-polynomial evaluation (scipy PPoly semantics, end-segment
    extrapolation) in float32 on ``x``'s device."""
    breaks = torch.as_tensor(breaks, dtype=torch.float32, device=x.device)
    coefs = torch.as_tensor(coefs, dtype=torch.float32, device=x.device)
    nseg = coefs.shape[1]
    idx = torch.clamp(torch.searchsorted(breaks, x, right=True) - 1, 0, nseg - 1)
    t = x - breaks[idx]
    res = coefs[0, idx]
    for k in range(1, coefs.shape[0]):
        res = res * t + coefs[k, idx]
    return res


def auto_vibrance(src: LABImage, device="cuda") -> LABImage:
    """Saturation boost preserving skin tones via a spline ratio (parity:
    ref lib/utils.py:116-131)."""
    (x1, c1), (x2, c2) = _vibrance_ppolys()
    A = _f32(src.A, device)
    B = _f32(src.B, A.device)
    return LABImage(
        L=src.L,
        A=A * _ppoly_eval(x2, c2, A) / _ppoly_eval(x1, c1, A),
        B=B * _ppoly_eval(x2, c2, B) / _ppoly_eval(x1, c1, B),
    )


def _edge_shift(img: torch.Tensor, rows, cols, sl_rows: slice, sl_cols: slice) -> torch.Tensor:
    """``np.pad(img, (rows, cols, (0, 0)...), 'edge')[sl_rows, sl_cols]``
    over the first two axes of (H, W[, C])."""
    h, w = img.shape[0], img.shape[1]
    ri = torch.clamp(torch.arange(-rows[0], h + rows[1], device=img.device), 0, h - 1)
    ci = torch.clamp(torch.arange(-cols[0], w + cols[1], device=img.device), 0, w - 1)
    return img.index_select(0, ri[sl_rows]).index_select(1, ci[sl_cols])


def divTV(image, device="cuda") -> torch.Tensor:
    """div(TV) via shifted forward/backward differences (the JAX package's
    working version of the reference's backup ``divTV``, ref
    lib/utils.py:319-351).  (H, W) planes or (H, W, C) images."""
    image = _f32(image, device)
    full = slice(None)
    grad = torch.zeros_like(image)
    # forward differences
    fx = _edge_shift(image, (0, 0), (1, 0), full, slice(1, None)) - image
    fy = _edge_shift(image, (1, 0), (0, 0), slice(1, None), full) - image
    grad = grad + (fx + fy) / torch.clamp(torch.sqrt(fx**2 + fy**2), min=1e-3)
    # backward x and crossed y
    fx = _edge_shift(image, (0, 0), (0, 1), full, slice(None, -1)) - image
    fy = _edge_shift(image, (0, 1), (1, 0), slice(None, -1), slice(1, None)) - _edge_shift(
        image, (1, 0), (0, 0), slice(1, None), full)
    grad = grad - fx / torch.clamp(torch.sqrt(fx**2 + fy**2), min=1e-3)
    # backward y and crossed x
    fy = _edge_shift(image, (0, 1), (0, 0), slice(None, -1), full) - image
    fx = _edge_shift(image, (1, 0), (0, 1), slice(1, None), slice(None, -1)) - _edge_shift(
        image, (0, 0), (0, 1), full, slice(1, None))
    grad = grad - fy / torch.clamp(torch.sqrt(fy**2 + fx**2), min=1e-3)
    return grad


def gradTVEM(u, ut, epsilon=1e-3, tau=1e-1, p=0.5, device="cuda") -> torch.Tensor:
    """MM Total-Variation gradient ``du / TV(u) / (tau + TV(ut))`` averaged
    over the four diagonal displacements (the JAX package's working version
    of the reference's dead backup ``gradTVEM``, ref lib/utils.py:357-417)."""
    u = _f32(u, device)
    ut = _f32(ut, u.device)
    h, w = u.shape[0], u.shape[1]

    def shifted(img, dy, dx):
        rows, cols = (max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0))
        return _edge_shift(img, rows, cols, slice(rows[1], rows[1] + h),
                           slice(cols[1], cols[1] + w))

    def tv(dy_, dx_):
        return (torch.abs(dy_) ** p + torch.abs(dx_) ** p + epsilon) ** (1.0 / p)

    grad = torch.zeros_like(u)
    for dy, dx in ((1, 1), (-1, 1), (1, -1), (-1, -1)):
        du_y = shifted(u, dy, 0) - u
        du_x = shifted(u, 0, dx) - u
        tvt = tv(shifted(ut, dy, 0) - ut, shifted(ut, 0, dx) - ut)
        grad = grad + (du_y + du_x) / tv(du_y, du_x) / (tau + tvt)
    return grad / 4.0


# --- HSV prototypes from notebooks/HSV color balance.ipynb ----------------


def _gaussian_weights(source, target, sigma):
    return torch.exp(-((source - target) ** 2) / (2 * sigma**2)) / (
        sigma * math.sqrt(2 * math.pi)
    )


def rgb_to_hsv(rgb, device="cuda") -> torch.Tensor:
    """Vectorized RGB -> HSV on [0,1] values, shape (..., 3)."""
    rgb = _f32(rgb, device)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.amax(rgb, dim=-1)
    minc = torch.amin(rgb, dim=-1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, 1.0), 0.0)
    safe = torch.where(delta > 0, delta, 1.0)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv, device="cuda") -> torch.Tensor:
    """Vectorized HSV -> RGB on [0,1] values, shape (..., 3).  The sector
    choice (``jnp.choose(..., mode='clip')`` in JAX) is a stacked gather."""
    hsv = _f32(hsv, device)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int64), 6)[None]  # in 0..5: 'clip' never bites

    def choose(*options):
        return torch.gather(torch.stack(options), 0, i)[0]

    return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                        choose(p, p, t, v, v, q)], dim=-1)


def normal2rad(theta, device="cuda") -> torch.Tensor:
    """[0,1] hue -> [-pi, pi] radians (notebook cell 2)."""
    theta = _f32(theta, device) * 2 * math.pi
    return torch.where(theta > math.pi, theta - 2 * math.pi, theta)


def rad2normal(theta, device="cuda") -> torch.Tensor:
    """[-pi, pi] radians -> [0,1] hue (notebook cell 2)."""
    theta = _f32(theta, device)
    theta = torch.where(theta < 0, 2 * math.pi + theta, theta)
    return theta / (2 * math.pi)


def hue_shift(source, target, amount, device="cuda") -> torch.Tensor:
    """Move hue angles toward ``target`` weighted by angular proximity
    (notebook ``hue``)."""
    source = _f32(source, device)
    if amount == 0:
        return source
    target = _f32(target, source.device).to(source.device)
    sigma = math.pi / 2.0
    x = torch.cos(source) + torch.cos(target) * _gaussian_weights(
        torch.cos(source), torch.cos(target), sigma) * sigma * amount
    y = torch.sin(source) + torch.sin(target) * _gaussian_weights(
        torch.sin(source), torch.sin(target), sigma) * sigma * amount
    return torch.atan2(y, x)


def saturation_boost(source, amount, device="cuda") -> torch.Tensor:
    """Saturation push weighted toward mid-saturation (notebook
    ``saturation``)."""
    source = _f32(source, device)
    if amount == 0.0:
        return source
    return source + amount * _gaussian_weights(source, 1.0 - source, 0.5)


def luma_masks(pixels, sigma=1.0 / 8.0, device="cuda"):
    """Normalized shadows / midtones / highlights Gaussian masks (notebook
    ``luma_masks``)."""
    pixels = _f32(pixels, device)
    high = _gaussian_weights(pixels, torch.amax(pixels), 2 * sigma)
    low = _gaussian_weights(pixels, torch.amin(pixels), 2 * sigma)
    mid = _gaussian_weights(pixels, 0.5, sigma) * (1 + 2 * sigma)
    norm = high + low + mid
    return low / norm, mid / norm, high / norm
