"""Image quality metrics: SSIM and PSNR (counterpart of
ics_tpu/utils/metrics.py).

Wang et al. 2004 with the skimage defaults (uniform 7x7 window, K1 = 0.01,
K2 = 0.03, sample covariance).  The device path computes in float32 on
``device``: the five window means of every channel in one 'valid'
convolution through the convolution dispatch (K1 on CUDA, its plain twin on
the CPU), over bands of rows of at most ``_BAND_ELEMS`` input elements, with
the SSIM map summed per band in float64.  Host inputs (NumPy arrays or CPU
tensors) of ``_HOST_METRIC_ELEMS`` elements or more take the float64
NumPy/SciPy host path instead, as in the JAX package; it gives the device
path's values on the interior, to float32's rounding: the variances
E[x^2] - E[x]^2 cancel on smooth frames, where the two paths' mean SSIM
differ by up to about 1e-5.  A CUDA tensor always takes the device path,
so scoring a frame on the card never copies it to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ics_tpu_torch._device import resolve_device, to_f32
from ics_tpu_torch.ops.conv import conv_planar

__all__ = ["ssim", "psnr"]

# ics_tpu/utils/metrics.py:24
_HOST_METRIC_ELEMS = 1 << 22
# input elements of one band of the device path: its five window-mean
# planes then take 80 MB
_BAND_ELEMS = 1 << 22


def _host_path(a) -> bool:
    """Large host inputs take the float64 host path."""
    if isinstance(a, torch.Tensor):
        return a.device.type == "cpu" and a.numel() >= _HOST_METRIC_ELEMS
    return np.asarray(a).size >= _HOST_METRIC_ELEMS


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _ssim_host(a, b, data_range: float, win_size: int) -> float:
    """NumPy/SciPy SSIM (copied from ics_tpu/utils/metrics.py:34-69): scipy's
    ``uniform_filter`` pads by reflection, which only touches a
    ``win_size // 2`` margin, cropped from the SSIM map."""
    from scipy.ndimage import uniform_filter

    a, b = _host(a), _host(b)
    if a.ndim == 2:
        a = a[..., np.newaxis]
        b = b[..., np.newaxis]
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    n = win_size * win_size
    cov_norm = n / (n - 1)
    pad = win_size // 2
    vals = []
    for c in range(a.shape[-1]):
        x, y = a[..., c], b[..., c]
        ux = uniform_filter(x, win_size)
        uy = uniform_filter(y, win_size)
        uxx = uniform_filter(x * x, win_size)
        uyy = uniform_filter(y * y, win_size)
        uxy = uniform_filter(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
            (ux**2 + uy**2 + c1) * (vx + vy + c2)
        )
        vals.append(float(np.mean(s[pad:-pad, pad:-pad])))
    return float(np.mean(vals))


def _ssim_device(a, b, data_range: float, win_size: int, dev: torch.device) -> float:
    a, b = to_f32(a, dev), to_f32(b, dev)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    h, w, c = a.shape
    x, y = a.permute(2, 0, 1), b.permute(2, 0, 1)
    kern = torch.ones((5 * c, win_size, win_size), dtype=torch.float32, device=dev) / (
        win_size * win_size)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    n = win_size * win_size
    cov_norm = n / (n - 1)  # sample covariance, as skimage uses
    rows = h - win_size + 1
    band = max(1, _BAND_ELEMS // (c * w) - win_size + 1)  # output rows per band
    total = torch.zeros(c, dtype=torch.float64, device=dev)
    for r0 in range(0, rows, band):
        xs = x[:, r0 : r0 + band + win_size - 1]
        ys = y[:, r0 : r0 + band + win_size - 1]
        # the five window means of every channel in one convolution
        stack = torch.cat([xs, ys, xs * xs, ys * ys, xs * ys]).contiguous()
        ux, uy, uxx, uyy, uxy = conv_planar(stack, kern, "valid").split(c)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
        total += torch.sum(s, dim=(1, 2), dtype=torch.float64)
    return float(torch.mean(total)) / (rows * (w - win_size + 1))


def ssim(a, b, data_range: float = 1.0, win_size: int = 7, device="cuda") -> float:
    """Mean SSIM over all channels of (H, W) or (H, W, C) arrays or tensors
    (skimage-compatible defaults); the device path runs on ``device``."""
    if _host_path(a):
        return _ssim_host(a, b, data_range, win_size)
    return _ssim_device(a, b, data_range, win_size, resolve_device(device))


def psnr(a, b, data_range: float = 1.0, device="cuda") -> float:
    """Peak signal-to-noise ratio in dB; the device path runs on ``device``."""
    if _host_path(a):
        mse = float(np.mean((_host(a) - _host(b)) ** 2))
        return float(10.0 * np.log10(data_range**2 / mse))
    dev = resolve_device(device)
    mse = torch.mean((to_f32(a, dev) - to_f32(b, dev)) ** 2)
    return float(10.0 * torch.log10(data_range**2 / mse))
