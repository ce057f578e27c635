"""K1: per-channel 2-D convolution kernel (csrc/conv2d.cu) and its plain twin.

Counterpart of ics_tpu/ops/pallas_conv.py.  Planar (C, H, W) float32 input,
(C, MK, NK) taps, scipy ``valid``/``same``/``full`` output.  On a CPU tensor
the wrapper runs the plain PyTorch twin; on a CUDA tensor it launches the
kernel or raises.  The kernel is register-blocked over a persistent grid
(unrolled for 3x3, 5x5, 7x7 and 9x9 taps, a run-time-size instance up to
31x31) and gives the same bits as a plain fmaf chain per output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ics_tpu_torch import _build
from ics_tpu_torch.ops.conv import _out_shape, _pads

__all__ = ["conv_planar", "conv_planar_plain", "MAX_TAPS_SIDE"]

MAX_TAPS_SIDE = 31  # csrc/conv2d.cu kMaxK: the run-time-size instance's bound
launches = 0  # kernel launches by conv_planar (the twin never counts)


def _check(a: torch.Tensor, k: torch.Tensor, mode: str) -> None:
    if a.ndim != 3 or k.ndim != 3 or a.shape[0] != k.shape[0]:
        raise ValueError(
            f"expected a (C, H, W) and k (C, MK, NK), got {tuple(a.shape)} "
            f"and {tuple(k.shape)}"
        )
    if a.dtype != torch.float32 or k.dtype != torch.float32:
        raise TypeError(f"float32 only, got {a.dtype} and {k.dtype}")
    if a.device != k.device:
        raise ValueError(f"a on {a.device} but k on {k.device}")
    if mode == "valid" and (a.shape[1] < k.shape[1] or a.shape[2] < k.shape[2]):
        raise ValueError("valid mode needs the image at least as large as k")
    _pads(1, mode)  # rejects an unknown mode


def conv_planar_plain(a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain PyTorch twin: zero pad, then grouped correlation with the
    flipped taps."""
    _check(a, k, mode)
    c, _, _ = a.shape
    plo, phi = _pads(k.shape[1], mode)
    qlo, qhi = _pads(k.shape[2], mode)
    padded = F.pad(a, (qlo, qhi, plo, phi))
    w = torch.flip(k, dims=(1, 2)).unsqueeze(1)
    return F.conv2d(padded.unsqueeze(0), w, groups=c)[0]


def conv_planar(a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """K1 on CUDA tensors (taps up to 31x31), the plain twin on CPU ones."""
    global launches
    if a.device.type == "cpu":
        return conv_planar_plain(a, k, mode)
    _check(a, k, mode)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    c, h, w = a.shape
    _, mk, nk = k.shape
    if mk > MAX_TAPS_SIDE or nk > MAX_TAPS_SIDE:
        raise ValueError(f"K1 takes taps up to {MAX_TAPS_SIDE}x{MAX_TAPS_SIDE}")
    if not (a.is_contiguous() and k.is_contiguous()):
        raise ValueError("K1 needs contiguous a and k")
    ho, wo = _out_shape(h, mk, mode), _out_shape(w, nk, mode)
    out = torch.empty((c, ho, wo), dtype=torch.float32, device=a.device)
    lib = _build.load_library()
    rc = lib.ics_conv2d(
        a.data_ptr(), k.data_ptr(), out.data_ptr(), c, h, w, mk, nk,
        _pads(mk, mode)[0], _pads(nk, mode)[0], ho, wo,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, "ics_conv2d")
    launches += 1
    return out
