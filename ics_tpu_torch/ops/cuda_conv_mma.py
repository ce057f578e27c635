"""K4s and K4: the banded tensor-core convolution (csrc/conv_mma.cu) and its
plain twins.

Counterpart of ics_tpu/ops/pallas_conv_mxu.py.  Planar (C, H, W) input,
(C, MK, NK) taps up to 31x31, scipy ``valid``/``same``/``full`` output.

* K4s (``conv_split``): float32 in and out, the bf16x3 emulation of f32
  (``_split_hi_lo``: hi*hi + hi*lo + lo*hi, f32 accumulation); about 1e-6
  of the largest value from the exact f32 convolution.
* K4 (``conv_bf16``): bfloat16 operands, f32 accumulation, bfloat16 output
  rounded once.

On CPU tensors the wrappers run the plain twins; on CUDA tensors they launch
the kernel or raise.
"""

from __future__ import annotations

import torch

from ics_tpu_torch import _build
from ics_tpu_torch.ops.conv import _out_shape, _pads
from ics_tpu_torch.ops.cuda_conv import conv_planar_plain

__all__ = [
    "conv_split", "conv_split_plain", "conv_bf16", "conv_bf16_plain",
    "split_hi_lo", "MAX_TAPS_SIDE",
]

MAX_TAPS_SIDE = 31  # csrc/conv_mma.cu kMaxK
split_launches = 0  # K4s launches by conv_split (the twin never counts)
bf16_launches = 0  # K4 launches by conv_bf16 (the twin never counts)


def split_hi_lo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo) bf16, as ics_tpu/ops/pallas_conv_mxu.py::_split_hi_lo:
    hi is x with its low 16 bits cleared (exact in bf16), lo = bf16(x - hi)."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi.to(torch.bfloat16), (x - hi).to(torch.bfloat16)


def _check(a: torch.Tensor, k: torch.Tensor, mode: str, dtype: torch.dtype) -> None:
    if a.ndim != 3 or k.ndim != 3 or a.shape[0] != k.shape[0]:
        raise ValueError(
            f"expected a (C, H, W) and k (C, MK, NK), got {tuple(a.shape)} "
            f"and {tuple(k.shape)}"
        )
    if a.dtype != dtype or k.dtype != dtype:
        raise TypeError(f"{dtype} only, got {a.dtype} and {k.dtype}")
    if a.device != k.device:
        raise ValueError(f"a on {a.device} but k on {k.device}")
    if k.shape[1] > MAX_TAPS_SIDE or k.shape[2] > MAX_TAPS_SIDE:
        raise ValueError(f"K4 takes taps up to {MAX_TAPS_SIDE}x{MAX_TAPS_SIDE}")
    if mode == "valid" and (a.shape[1] < k.shape[1] or a.shape[2] < k.shape[2]):
        raise ValueError("valid mode needs the image at least as large as k")
    _pads(1, mode)  # rejects an unknown mode


def conv_split_plain(a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain twin of K4s: three f32 grouped convolutions of the bf16-valued
    halves (TF32 off, ``_device.exact_f32``)."""
    _check(a, k, mode, torch.float32)
    ah, al = (x.float() for x in split_hi_lo(a))
    kh, kl = (x.float() for x in split_hi_lo(k))
    return (conv_planar_plain(ah, kh, mode) + conv_planar_plain(ah, kl, mode)
            + conv_planar_plain(al, kh, mode))


def conv_bf16_plain(a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain twin of K4: an f32 convolution of the bf16 operands, rounded
    to bf16 once."""
    _check(a, k, mode, torch.bfloat16)
    return conv_planar_plain(a.float(), k.float(), mode).to(torch.bfloat16)


def _launch(entry: str, a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if not (a.is_contiguous() and k.is_contiguous()):
        raise ValueError("K4 needs contiguous a and k")
    c, h, w = a.shape
    _, mk, nk = k.shape
    ho, wo = _out_shape(h, mk, mode), _out_shape(w, nk, mode)
    out = torch.empty((c, ho, wo), dtype=a.dtype, device=a.device)
    rc = getattr(_build.load_library(), entry)(
        a.data_ptr(), k.data_ptr(), out.data_ptr(), c, h, w, mk, nk,
        _pads(mk, mode)[0], _pads(nk, mode)[0], ho, wo,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, entry)
    return out


def conv_split(a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """K4s on CUDA tensors, its plain twin on CPU ones (float32)."""
    global split_launches
    if a.device.type == "cpu":
        return conv_split_plain(a, k, mode)
    _check(a, k, mode, torch.float32)
    out = _launch("ics_conv_mma_split", a, k, mode)
    split_launches += 1
    return out


def conv_bf16(a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """K4 on CUDA tensors, its plain twin on CPU ones (bfloat16)."""
    global bf16_launches
    if a.device.type == "cpu":
        return conv_bf16_plain(a, k, mode)
    _check(a, k, mode, torch.bfloat16)
    out = _launch("ics_conv_mma_bf16", a, k, mode)
    bf16_launches += 1
    return out
