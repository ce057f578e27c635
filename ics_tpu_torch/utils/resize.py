"""``jax.image.resize``'s resize (counterpart of ``resize_jax`` in
ics_tpu/utils/resize.py:51-70), every method it takes; the pipeline uses
the cubic.

JAX resizes by one dense weight matrix per axis whose size changes, built by
``jax._src.image.scale.compute_weight_mat``: the kernel (the Keys cubic,
a = -0.5; the triangle; Lanczos of radius 3 or 5) at half-pixel centers; on
downscale the kernel is widened by 1/scale (antialiasing); each output's
weights are renormalized to sum 1 (which drops the taps that fall outside
the input); outputs whose sample point lies outside the input get weight 0.
``weight_matrix`` builds that matrix the same way, with the same float32
sample positions, on the host (and copies it to the device it is given);
``band_tables`` builds, by the same recipe, only the taps inside each
output's support (a start, a count and the weights), which is all an axis of
a 24 MP level needs of a matrix of 25 M entries.  ``resize_jax`` resizes each
axis through ``ops.cuda_resize.resample``: a CUDA tensor takes the banded
kernel (``csrc/resize.cu``; the tables cached per shape and method, uploaded
once per device, no dense matrix on the card), a CPU tensor the dense twin,
``weight_matrix``'s float32 product with TF32 off.
``'nearest'`` gathers, as ``jax._src.image.scale._resize_nearest`` does, and
keeps the dtype.  ``F.interpolate(mode="bicubic")`` uses another coefficient,
edge rule and no antialiasing: it is not this function.

``resize`` is the host-side SciPy resize of ``resize_backend="scipy"``,
copied from ics_tpu/utils/resize.py:26-48 (the port never imports
``ics_tpu``, whose package import loads JAX).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from scipy import ndimage

__all__ = ["resize", "resize_jax", "weight_matrix", "band_tables", "METHODS"]


def resize(image: np.ndarray, shape, order: int = 3, mode: str = "edge") -> np.ndarray:
    """Resize (H, W) or (H, W, C) to ``shape`` (spatial dims of shape only)
    with skimage.transform.resize's sampling: centered coordinates, an
    order-3 B-spline (scipy.ndimage.map_coordinates), edge replication."""
    image = np.asarray(image)
    out_h, out_w = int(shape[0]), int(shape[1])
    in_h, in_w = image.shape[:2]
    # skimage/scipy 'edge' replication is ndimage mode 'nearest'
    nd_mode = {"edge": "nearest", "reflect": "reflect", "wrap": "wrap"}[mode]

    row = (np.arange(out_h) + 0.5) * (in_h / out_h) - 0.5
    col = (np.arange(out_w) + 0.5) * (in_w / out_w) - 0.5
    rr, cc = np.meshgrid(row, col, indexing="ij")
    coords = np.stack([rr, cc])

    def _one(plane):
        return ndimage.map_coordinates(
            plane.astype(np.float64), coords, order=order, mode=nd_mode
        )

    if image.ndim == 2:
        out = _one(image)
    else:
        out = np.stack([_one(image[..., c]) for c in range(image.shape[-1])], axis=-1)
    return out.astype(image.dtype if image.dtype.kind == "f" else np.float32)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _lanczos(radius: float, x: torch.Tensor) -> torch.Tensor:
    y = radius * torch.sin(np.pi * x) * torch.sin(np.pi * x / radius)
    out = torch.where(x > 1e-3, y / torch.where(x != 0, np.pi**2 * x**2, torch.ones_like(x)),
                      torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


# jax.image.ResizeMethod.from_string's names
_KERNELS = {"linear": _triangle, "cubic": _keys_cubic,
            "lanczos3": functools.partial(_lanczos, 3.0),
            "lanczos5": functools.partial(_lanczos, 5.0)}
# each kernel is 0 beyond this |x| (Lanczos reaches its radius itself)
_RADIUS = {"linear": 1.0, "cubic": 2.0, "lanczos3": 3.0, "lanczos5": 5.0}
_ALIASES = {"bilinear": "linear", "trilinear": "linear", "triangle": "linear",
            "bicubic": "cubic", "tricubic": "cubic"}
METHODS = ("nearest", *_KERNELS, *_ALIASES)


def _method(method: str) -> str:
    if method not in METHODS:
        raise ValueError(f'Unknown resize method "{method}"')
    return _ALIASES.get(method, method)


def _samples(in_size: int, out_size: int) -> tuple[float, torch.Tensor]:
    """The kernel's scale and each output's float32 sample position."""
    # JAX: scale = out/in and inv_scale = 1/scale in double (Python floats),
    # rounded to float32 where they meet float32 arrays
    inv_scale = float(np.float32(1.0 / (out_size / in_size)))
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    return max(inv_scale, 1.0), sample_f


def _weights(kernel, taps: torch.Tensor, sample_f: torch.Tensor, kernel_scale: float,
             in_size: int, valid: torch.Tensor | None = None) -> torch.Tensor:
    """float32 weights of the float32 input positions ``taps`` (one row per
    tap, one column per output; ``valid`` False where a row holds no tap of
    that column): the kernel at their float32 distances, renormalized over
    each column, 0 for an output sampled outside the input."""
    x = torch.abs(sample_f[None, :] - taps) / kernel_scale
    # the kernel and its renormalization in float64, rounded once: JAX's
    # float32 rounding of them depends on the backend's FMA contraction, and
    # float64 lands within a few 1e-7 of each backend's result
    weights = kernel(x.double())
    if valid is not None:
        weights = torch.where(valid, weights, torch.zeros_like(weights))
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(torch.float32)


@functools.lru_cache(maxsize=32)
def weight_matrix(in_size: int, out_size: int, device: str = "cpu",
                  method: str = "cubic") -> torch.Tensor:
    """(in_size, out_size) float32 weights of one resized axis, for any
    method but 'nearest', on ``device``.  Built on the host: CUDA divides a
    tensor by a Python scalar as a product with its reciprocal, which moves
    some float32 distances of a downscale by an ulp."""
    if torch.device(device).type != "cpu":
        return weight_matrix(in_size, out_size, "cpu", method).to(device)
    kernel_scale, sample_f = _samples(in_size, out_size)
    taps = torch.arange(in_size, dtype=torch.float32)[:, None]
    return _weights(_KERNELS[_method(method)], taps, sample_f, kernel_scale, in_size)


@functools.lru_cache(maxsize=64)
def band_tables(in_size: int, out_size: int,
                method: str = "cubic") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The non-zero band of each column of ``weight_matrix(in_size,
    out_size, method=method)``, on the host: ``start`` and ``count``
    ((out_size,) int32) and the weights ((taps, out_size) float32, tap-major,
    zero past each column's count), taps the widest column's count.

    The same recipe restricted to a window that holds each output's kernel
    support (the same float32 positions and distances, the kernel and the
    renormalization in float64, rounded once): only the float64 sum's order
    differs from the dense matrix's, which moves a weight by at most 1 ulp.
    An output sampled outside the input has an empty band (count 0); zeros
    inside a band stay in it."""
    kernel_scale, sample_f = _samples(in_size, out_size)
    return _bands(_method(method), in_size, sample_f, kernel_scale)


def _bands(name: str, in_size: int, sample_f: torch.Tensor, kernel_scale: float):
    """``band_tables`` of the sample positions ``sample_f``."""
    reach = _RADIUS[name] * kernel_scale
    first = torch.clamp(torch.floor(sample_f.double() - reach).long() - 1, 0, in_size - 1)
    last = torch.clamp(torch.ceil(sample_f.double() + reach).long() + 1, 0, in_size - 1)
    window = first[None, :] + torch.arange(int((last - first).max()) + 1)[:, None]
    weights = _weights(_KERNELS[name], window.to(torch.float32), sample_f, kernel_scale, in_size,
                       valid=window <= last[None, :])
    nonzero = weights != 0
    lead = nonzero.int().argmax(dim=0)  # the first non-zero tap (0 when none)
    count = torch.where(nonzero.any(dim=0),
                        nonzero.shape[0] - nonzero.flip(0).int().argmax(dim=0) - lead,
                        torch.zeros_like(lead))
    taps = max(int(count.max()), 1)
    t = torch.arange(taps)[:, None]
    at = torch.clamp(lead[None, :] + t, max=weights.shape[0] - 1)
    band = torch.where(t < count[None, :], weights.gather(0, at),
                       torch.zeros((), dtype=torch.float32))
    start = torch.where(count > 0, first + lead, torch.zeros_like(first))
    return start.int(), count.int(), band.contiguous()


def _nearest(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Source index floor((i + 0.5) * in / out) in float32 along each resized
    axis, as JAX computes it; the dtype is kept."""
    out = image
    for axis, n in ((0, out_h), (1, out_w)):
        m = out.shape[axis]
        if m != n:
            at = (torch.arange(n, dtype=torch.float32, device=image.device) + 0.5) * m / n
            out = out.index_select(axis, torch.floor(at).long())
    return out


def resize_jax(image: torch.Tensor, shape, method: str = "cubic") -> torch.Tensor:
    """Resize (H, W, ...) to ``shape[:2]`` spatially, on the tensor's device,
    with any method that ``jax.image.resize`` takes (``METHODS``; another
    name raises ``ValueError``).

    Axes whose size does not change are left as they are (JAX skips them
    too), so a same-size call returns ``image`` itself.  Every method but
    'nearest' computes in float32: the rows first, then the columns, each by
    ``ops.cuda_resize.resample`` (the banded kernel on a CUDA tensor, the
    dense twin on a CPU one).
    """
    from ics_tpu_torch.ops import cuda_resize  # it imports this module's tables

    out_h, out_w = int(shape[0]), int(shape[1])
    if _method(method) == "nearest":
        return _nearest(image, out_h, out_w)
    in_h, in_w = image.shape[0], image.shape[1]
    out = image.to(torch.float32)
    if out.is_cuda and (in_h, in_w) != (out_h, out_w):
        out = out.contiguous()  # the kernel reads whole rows
    if in_h != out_h:
        out = cuda_resize.resample(out, 0, out_h, method)
    if in_w != out_w:
        out = cuda_resize.resample(out, 1, out_w, method)
    return out
