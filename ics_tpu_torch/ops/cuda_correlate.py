"""K3: the blind PSF gradient kernel (csrc/psf_grad.cu) and its plain twin.

Counterpart of ics_tpu/ops/pallas_correlate.py:

    gradk = conv_valid(rot180(u), err) = rot180(corr_valid(u, err))

MK*NK whole-window dot products per channel, computed without any rotated
copy of ``u``.  On a CPU tensor the wrapper runs the plain twin; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ics_tpu_torch import _build

__all__ = [
    "psf_gradient_planar",
    "psf_gradient_plain",
    "psf_gradient",
    "correlate_psf_valid",
]

MAX_TAPS_SIDE = 32  # csrc/psf_grad.cu: column taps live in registers
_TARGET_BLOCKS = 528  # pass-1 blocks: four per SM of an H100
launches = 0  # kernel launches by psf_gradient_planar (the twin never counts)


def _check(u: torch.Tensor, err: torch.Tensor) -> tuple[int, int]:
    if u.ndim != 3 or err.ndim != 3 or u.shape[0] != err.shape[0]:
        raise ValueError(
            f"expected u (C, uM, uN) and err (C, M, N), got {tuple(u.shape)} "
            f"and {tuple(err.shape)}"
        )
    if u.dtype != torch.float32 or err.dtype != torch.float32:
        raise TypeError(f"float32 only, got {u.dtype} and {err.dtype}")
    if u.device != err.device:
        raise ValueError(f"u on {u.device} but err on {err.device}")
    mk = u.shape[1] - err.shape[1] + 1
    nk = u.shape[2] - err.shape[2] + 1
    if mk < 1 or nk < 1:
        raise ValueError("u must be at least as large as err")
    return mk, nk


def psf_gradient_plain(u: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: one whole-window sum per tap, then the flip."""
    mk, nk = _check(u, err)
    _, m, n = err.shape
    corr = torch.stack(
        [
            torch.stack(
                [
                    torch.sum(u[:, ti : ti + m, tj : tj + n] * err, dim=(1, 2))
                    for tj in range(nk)
                ],
                dim=-1,
            )
            for ti in range(mk)
        ],
        dim=-2,
    )
    return torch.flip(corr, dims=(1, 2))


def psf_gradient_planar(u: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """rot180(corr_valid(u, err)) of planar u (C, uM, uN) and err (C, M, N):
    K3 on CUDA tensors, the plain twin on CPU ones."""
    global launches
    if u.device.type == "cpu":
        return psf_gradient_plain(u, err)
    mk, nk = _check(u, err)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    if nk > MAX_TAPS_SIDE:
        raise ValueError(f"K3 takes outputs up to {MAX_TAPS_SIDE} columns")
    if not (u.is_contiguous() and err.is_contiguous()):
        raise ValueError("K3 needs contiguous u and err")
    c, u_m, u_n = u.shape
    _, m, n = err.shape
    band_rows = max(1, -(-m * c // _TARGET_BLOCKS))
    n_bands = -(-m // band_rows)
    partial = torch.empty((n_bands, c, mk * nk), dtype=torch.float32, device=u.device)
    out = torch.empty((c, mk, nk), dtype=torch.float32, device=u.device)
    lib = _build.load_library()
    rc = lib.ics_psf_grad(
        u.data_ptr(), err.data_ptr(), partial.data_ptr(), out.data_ptr(),
        c, u_m, u_n, m, n, band_rows, n_bands,
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    _build.check(rc, "ics_psf_grad")
    launches += 1
    return out


def psf_gradient(u: torch.Tensor, error: torch.Tensor) -> torch.Tensor:
    """``conv_valid(rot180(u), error)``, the blind PSF gradient.

    u: (uM, uN, C); error: (M, N, C); returns (MK, MK, C), MK = uM - M + 1.
    """
    out = psf_gradient_planar(
        u.permute(2, 0, 1).contiguous(), error.permute(2, 0, 1).contiguous()
    )
    return out.permute(1, 2, 0)


def correlate_psf_valid(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Generic ``conv_valid(a, b)`` of (H, W, C) tensors with a small output,
    by conv_valid(a, b) = rot180(corr_valid(rot180(a), b))."""
    return psf_gradient(torch.flip(a, dims=(0, 1)), b)
