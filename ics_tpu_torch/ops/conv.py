"""2-D convolution with exact scipy.signal.convolve ``valid|same|full``
semantics (counterpart of ics_tpu/ops/conv.py).

``method`` and ``precision`` take the JAX package's names (its
``_dispatch``, ics_tpu/ops/conv.py:367-450); ``precision`` is ``'exact'``
(``lax.Precision.HIGHEST``), ``'bf16x3'`` or ``'fast'``
(``lax.Precision.DEFAULT``).  Each hand-written kernel runs on CUDA tensors
and its plain twin on CPU tensors.

``method='auto'`` picks by dtype, precision and kernel size:

* float32 with ``precision="bf16x3"`` and 81-961 taps: K4s
  (``ops/cuda_conv_mma.py``), the hi/lo-split tensor-core kernel.  That is
  where the JAX package ran its split kernel on the TPU, so ``high``
  deviates from exact f32 where it did there.
* other float32 convolutions with taps up to 31x31: K1 (``ops/cuda_conv.py``),
  at every precision.  The JAX package sends 81-961 taps to its Pallas
  kernel and smaller ones to XLA stencils; the port sends them all to K1.
* bfloat16 convolutions with taps up to 31x31: K4 (``ops/cuda_conv_mma.py``),
  f32 accumulation and one rounding.  A stated deviation: JAX's bf16
  stencil under 81 taps rounds its partial sums to bf16.
* ``torch.fft`` above 31 taps a side (``_conv_fft``), the JAX ``fft``
  backend: float32 math, cast back to the input dtype.

The explicit methods, for taps up to 31 a side:

* ``'pallas_mxu'`` and ``'mxu'`` (JAX's MXU Pallas kernel and its XLA
  banded product, the same function at the same precision): K4 on bfloat16
  operands; on float32 ones K4h at ``'exact'``, K4s at ``'bf16x3'`` and K4d
  at ``'fast'``.  JAX's explicit path turns ``'bf16x3'`` into HIGHEST
  before it reaches the kernel (ics_tpu/ops/conv.py:369-373); the port runs
  the split kernel that the name asks for, within 1e-5 of HIGHEST.
* ``'pallas'`` and ``'stencil'`` (JAX's VPU Pallas kernel and its XLA
  shift-and-add, the same f32 function): K1 on float32, K4 on bfloat16
  under the deviation above.
* ``'direct'``: cuDNN's grouped ``conv2d`` with TF32 off
  (``_device.exact_f32``; bfloat16 computed in f32 and rounded once).  It
  is the counterpart of ``lax.conv_general_dilated``, which JAX runs
  outside any Pallas kernel, as the port runs this outside its own.
* ``'fft'``: ``_conv_fft`` (cuFFT on the card).

Above 31 taps a side, where no kernel instance takes them, ``'pallas_mxu'``,
``'pallas'`` and ``'stencil'`` take ``'direct'``, as JAX falls back when its
tile does not fit (ics_tpu/ops/conv.py:266-275, :335-339); ``'pallas_mxu'``
raises ``ValueError`` above 129 columns (:315-321) and ``'mxu'`` takes
``'fft'`` above 128 (:208-209).  Any other method raises ``ValueError``.

``fft_autocorrelate_same`` is the residual-whiteness autocovariance of the
solver's stopping rule.
"""

from __future__ import annotations

import functools

import torch

__all__ = [
    "convolve2d", "convolve_rgb", "conv_planar", "fft_autocorrelate_same", "pad_symmetric",
]


def _out_shape(m: int, mk: int, mode: str) -> int:
    if mode == "valid":
        return m - mk + 1
    if mode == "same":
        return m
    if mode == "full":
        return m + mk - 1
    raise ValueError(f"unknown mode {mode!r}")


def _pads(mk: int, mode: str) -> tuple[int, int]:
    """Per-axis (lo, hi) padding so that correlation-with-flipped-kernel at
    this padding equals the scipy convolution slice for ``mode``.

    With the kernel flipped, out[i] = full[i + (mk-1) - lo]:
    full → lo = hi = mk-1; same → lo = ceil((mk-1)/2), hi = (mk-1)//2;
    valid → lo = hi = 0.
    """
    if mode == "valid":
        return (0, 0)
    if mode == "full":
        return (mk - 1, mk - 1)
    if mode == "same":
        off = (mk - 1) // 2
        return (mk - 1 - off, off)
    raise ValueError(f"unknown mode {mode!r}")


def _symmetric_index(n: int, lo: int, hi: int) -> torch.Tensor:
    """Source indices of ``np.pad(x, (lo, hi), 'symmetric')`` along a side of
    ``n``: the edge repeats, with period 2n, so any width is right."""
    m = torch.remainder(torch.arange(-lo, n + hi), 2 * n)
    return torch.where(m < n, m, 2 * n - 1 - m)


def pad_symmetric(x: torch.Tensor, rows, cols) -> torch.Tensor:
    """``np.pad(..., 'symmetric')`` of the last two axes by ``rows`` and
    ``cols`` (each (lo, hi)); ``F.pad``'s 'reflect' leaves the edge out."""
    h, w = x.shape[-2], x.shape[-1]
    ri = _symmetric_index(h, *rows).to(x.device)
    ci = _symmetric_index(w, *cols).to(x.device)
    return x.index_select(-2, ri).index_select(-1, ci)


@functools.lru_cache(maxsize=None)
def _next_fast_len(n: int) -> int:
    """Smallest 2/3/5-smooth integer >= n."""
    if n <= 2:
        return n
    best = 1 << (n - 1).bit_length()  # next power of two is an upper bound
    p5 = 1
    while p5 < best:
        p53 = p5
        while p53 < best:
            # round p53 up by powers of two
            rem = -(-n // p53)  # ceil(n / p53)
            p2 = 1 << max(0, (rem - 1).bit_length())
            cand = p53 * p2
            if n <= cand < best:
                best = cand
            p53 *= 3
        p5 *= 5
    return best


def _conv_fft(a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """Batched FFT convolution. a: (C, H, W); k: (C, MK, NK).  The FFTs run
    in float32; the result is cast back to ``a``'s dtype (conv.py:161-181)."""
    dtype = a.dtype
    a, k = a.float(), k.float()
    _, m, n = a.shape
    _, mk, nk = k.shape
    mf, nf = m + mk - 1, n + nk - 1
    s = (_next_fast_len(mf), _next_fast_len(nf))
    fa = torch.fft.rfft2(a, s=s, dim=(-2, -1))
    fk = torch.fft.rfft2(k, s=s, dim=(-2, -1))
    full = torch.fft.irfft2(fa * fk, s=s, dim=(-2, -1))[..., :mf, :nf]
    ym, xn = _out_shape(m, mk, mode), _out_shape(n, nk, mode)
    oy, ox = (mf - ym) // 2, (nf - xn) // 2
    return full[:, oy : oy + ym, ox : ox + xn].to(dtype).contiguous()


_SPLIT_MIN_TAPS = 9 * 9  # ics_tpu/ops/conv.py:40 _MXU_THRESHOLD_TAPS
METHODS = ("auto", "stencil", "pallas", "pallas_mxu", "mxu", "direct", "fft")
PRECISIONS = ("exact", "bf16x3", "fast")
_MXU_MAX_WIDTH = 129  # pallas_mxu's 2 x 128-lane window (ics_tpu/ops/conv.py:315-321)


def _conv_direct(a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """cuDNN's grouped convolution with TF32 off, computed in float32 and
    cast back to ``a``'s dtype (JAX's ``direct``, ``_conv_direct``)."""
    from ics_tpu_torch._device import exact_f32
    from ics_tpu_torch.ops.cuda_conv import conv_planar_plain

    exact_f32()
    return conv_planar_plain(a.float(), k.float(), mode).to(a.dtype)


def conv_planar(a: torch.Tensor, k: torch.Tensor, mode: str,
                precision: str = "exact", method: str = "auto") -> torch.Tensor:
    """Per-channel convolution of planar a: (C, H, W) with k: (C, MK, NK),
    routed by ``method`` and ``precision`` as the module's docstring says."""
    from ics_tpu_torch.ops import cuda_conv, cuda_conv_mma

    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} (use {', '.join(PRECISIONS)})")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r} (use {', '.join(METHODS)})")
    mk, nk = k.shape[1], k.shape[2]
    small = max(mk, nk) <= cuda_conv.MAX_TAPS_SIDE
    bf16 = a.dtype == torch.bfloat16
    if method == "auto":
        if not small:
            return _conv_fft(a, k, mode)
        if bf16:
            return cuda_conv_mma.conv_bf16(a, k, mode)
        if precision == "bf16x3" and mk * nk >= _SPLIT_MIN_TAPS:
            return cuda_conv_mma.conv_split(a, k, mode)
        return cuda_conv.conv_planar(a, k, mode)
    if method == "pallas_mxu" and nk > _MXU_MAX_WIDTH:
        raise ValueError(f"pallas_mxu supports kernel widths <= {_MXU_MAX_WIDTH}, got {nk}")
    if method == "fft" or (method == "mxu" and nk > _MXU_MAX_WIDTH - 1):
        return _conv_fft(a, k, mode)
    if method == "direct" or not small:
        return _conv_direct(a, k, mode)
    if bf16:
        return cuda_conv_mma.conv_bf16(a, k, mode)
    if method in ("pallas", "stencil"):
        return cuda_conv.conv_planar(a, k, mode)
    mxu = {"exact": cuda_conv_mma.conv_highest, "bf16x3": cuda_conv_mma.conv_split,
           "fast": cuda_conv_mma.conv_default}
    return mxu[precision](a, k, mode)


def convolve2d(a: torch.Tensor, k: torch.Tensor, mode: str = "same", method: str = "auto",
               precision: str = "exact") -> torch.Tensor:
    """scipy.signal.convolve-compatible 2-D convolution of (H, W) tensors."""
    return conv_planar(a.unsqueeze(0).contiguous(), k.unsqueeze(0).contiguous(), mode,
                       precision, method)[0]


def convolve_rgb(a: torch.Tensor, k: torch.Tensor, mode: str = "same", method: str = "auto",
                 precision: str = "exact") -> torch.Tensor:
    """Per-channel 2-D convolution of an (H, W, C) image.

    ``k`` is (MK, NK, C), each channel with its own kernel, or (MK, NK),
    broadcast across channels.
    """
    if k.ndim == 2:
        k = k.unsqueeze(-1).expand(*k.shape, a.shape[-1])
    out = conv_planar(
        a.permute(2, 0, 1).contiguous(), k.permute(2, 0, 1).contiguous(), mode, precision, method
    )
    return out.permute(1, 2, 0)


def _autocorrelate_planar(t: torch.Tensor) -> torch.Tensor:
    """``convolve(t, rot180(t), 'same')`` per channel of planar (C, H, W)."""
    _, m, n = t.shape
    mf, nf = 2 * m - 1, 2 * n - 1
    s = (_next_fast_len(mf), _next_fast_len(nf))
    ft = torch.fft.rfft2(t, s=s, dim=(-2, -1))
    # conv(t, rot180(t)) is |F(t)|² up to the rot180 shift, which in index
    # space is a circular shift by (m-1, n-1) of the inverse transform
    full = torch.fft.irfft2(ft * torch.conj(ft), s=s, dim=(-2, -1))
    full = torch.roll(full, shifts=(m - 1, n - 1), dims=(-2, -1))[..., :mf, :nf]
    oy, ox = (mf - m) // 2, (nf - n) // 2
    return full[:, oy : oy + m, ox : ox + n]


def fft_autocorrelate_same(patch: torch.Tensor) -> torch.Tensor:
    """``convolve(t, rot90(t, 2), mode='same')`` per channel of an (H, W, C)
    patch, via one FFT (ics_tpu/ops/conv.py:490-516)."""
    return _autocorrelate_planar(patch.permute(2, 0, 1)).permute(1, 2, 0)
