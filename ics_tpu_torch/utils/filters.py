"""Classic filters: bilateral, Bessel/Gaussian blur, unsharp mask, blending
(counterpart of ics_tpu/utils/filters.py; parity targets: reference
lib/utils.py:173-300).

Every function takes NumPy arrays or tensors, moves them to ``device``
('cuda', the default, raises without a GPU; or 'cpu') as float32 and
returns a float32 tensor there.  ``bilateral_filter`` runs K6
(``ops/cuda_bilateral.py``) on CUDA tensors; the blurs and ``convolve`` go
through ``ops/conv.py``, so a 5x5 window runs K1 there.  On the CPU each
kernel's plain twin runs.
"""

from __future__ import annotations

import torch

from ics_tpu_torch._device import resolve_device, to_f32
from ics_tpu_torch.ops.conv import convolve2d, convolve_rgb, pad_symmetric
from ics_tpu_torch.ops.cuda_bilateral import bilateral_planar
from ics_tpu_torch.ops.windows import gaussian_kernel, kaiser_kernel
from ics_tpu_torch.utils.color import LABImage, lab_to_rgb, rgb_to_lab

__all__ = [
    "bilateral_filter",
    "bilateral_lab",
    "bessel_blur",
    "gaussian_blur",
    "USM",
    "overlay",
    "blending",
    "convolve",
]


def bilateral_filter(source, radius: int, std_i, std_s, parallel: int = 1,
                     device="cuda") -> torch.Tensor:
    """Edge-preserving bilateral filter of a 2-D plane (parity: ref
    lib/utils.py:195-234; ``parallel`` is accepted for the signature and
    ignored).  On a CUDA tensor it launches K6, at any size; a radius above
    ``cuda_bilateral.MAX_RADIUS`` raises there."""
    dev = resolve_device(device)
    src = to_f32(source, dev)
    if src.ndim != 2:
        raise ValueError(f"bilateral_filter takes a 2-D plane, got {tuple(src.shape)}")
    return bilateral_planar(src.unsqueeze(0).contiguous(), int(radius), float(std_i),
                            float(std_s))[0]


def bilateral_lab(rgb, radius: int, std_i, std_s, luminance_only: bool = True,
                  device="cuda") -> torch.Tensor:
    """Bilateral denoise in CIELAB (the reference's ``img/bilateral-LAB``
    workflow): sRGB -> LAB, filter L (or all three channels), back to sRGB.
    ``std_i`` is in L units (0-100 scale)."""
    dev = resolve_device(device)
    lab = rgb_to_lab(to_f32(rgb, dev))
    l = bilateral_filter(lab.L, radius, std_i, std_s, device=dev)
    if luminance_only:
        a, b = lab.A, lab.B
    else:
        a = bilateral_filter(lab.A, radius, std_i, std_s, device=dev)
        b = bilateral_filter(lab.B, radius, std_i, std_s, device=dev)
    return lab_to_rgb(LABImage(L=l, A=a, B=b))


def _blur_same_symm(src: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    # scipy.signal.convolve2d(..., mode='same', boundary='symm'): symmetric
    # padding by the kernel's ceil/floor half-widths, then valid convolution
    mk, nk = kern.shape
    top, bottom = (mk - 1) - (mk - 1) // 2, (mk - 1) // 2
    leftp, rightp = (nk - 1) - (nk - 1) // 2, (nk - 1) // 2
    return convolve2d(pad_symmetric(src, (top, bottom), (leftp, rightp)), kern, mode="valid")


def bessel_blur(src, radius: int, amount, device="cuda") -> torch.Tensor:
    """Kaiser-Bessel window blur (parity: ref lib/utils.py:238-249)."""
    dev = resolve_device(device)
    return _blur_same_symm(to_f32(src, dev), to_f32(kaiser_kernel(radius, amount), dev))


def gaussian_blur(src, radius: int, amount, device="cuda") -> torch.Tensor:
    """Gaussian window blur (parity: ref lib/utils.py:253-264)."""
    dev = resolve_device(device)
    return _blur_same_symm(to_f32(src, dev), to_f32(gaussian_kernel(radius, amount), dev))


def USM(src, radius: int, strength, amount, method: str = "bessel",
        device="cuda") -> torch.Tensor:
    """Unsharp mask ``src + (src - blur(src)) * amount`` (parity: ref
    lib/utils.py:268-277)."""
    blur = {"bessel": bessel_blur, "gauss": gaussian_blur}[method]
    src = to_f32(src, resolve_device(device))
    return src + (src - blur(src, radius, strength, device=src.device)) * amount


def overlay(upx, lpx, device="cuda") -> torch.Tensor:
    """Overlay blending on the 0-100 scale (parity: ref lib/utils.py:281-287,
    including the exclusive masks that zero out lpx == 50)."""
    dev = resolve_device(device)
    upx, lpx = to_f32(upx, dev), to_f32(lpx, dev)
    low = (lpx < 50).to(upx.dtype)
    high = (lpx > 50).to(upx.dtype)
    return low * (2.0 * upx * lpx / 100.0) + high * (
        100.0 - 2.0 * (100.0 - upx) * (100.0 - lpx) / 100.0
    )


def blending(upx, lpx, type: str, device="cuda") -> torch.Tensor:
    """Dispatch blending modes (parity: ref lib/utils.py:291-300)."""
    types = {"overlay": overlay}
    return types[type](upx, lpx, device=device)


def convolve(a, b, domain: str, device="cuda") -> torch.Tensor:
    """General 2-D convolution with ``valid | same | full`` output domains,
    scipy.signal.convolve's sizes and values (counterpart of
    ics_tpu/utils/filters.py::convolve; ref lib/utils.py:420-447).

    Accepts (H, W) planes or (H, W, C) images (per-channel kernels as
    (MK, NK, C), or (MK, NK) broadcast)."""
    if domain not in ("valid", "same", "full"):
        # ref lib/utils.py:439 raises bare SyntaxError on unknown domains
        raise ValueError(f"domain must be valid|same|full, got {domain!r}")
    dev = resolve_device(device)
    a, b = to_f32(a, dev), to_f32(b, dev)
    if a.ndim == 2:
        return convolve2d(a, b, mode=domain)
    return convolve_rgb(a, b, mode=domain)
