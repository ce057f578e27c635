"""K3: the blind PSF gradient kernel (csrc/psf_grad.cu) and its plain twin.

Counterpart of ics_tpu/ops/pallas_correlate.py:

    gradk = conv_valid(rot180(u), err) = rot180(corr_valid(u, err))

MK*NK whole-window dot products per channel, computed without any rotated
copy of ``u``.  On a CPU tensor the wrapper runs the plain twin; on a CUDA
tensor it launches the kernel or raises.  ``geometry`` chooses the launch:
the template instance, the work units (channel, tap-row chunk, row band,
column strip), the persistent grid and the stage's shared memory; the
kernel refuses a geometry that does not match its call.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ics_tpu_torch import _build

__all__ = [
    "psf_gradient_planar",
    "psf_gradient_plain",
    "psf_gradient",
    "correlate_psf_valid",
    "geometry",
]

MAX_TAPS_SIDE = 32  # csrc/psf_grad.cu kMaxTapsSide: column sums live in registers
UNROLLED = (3, 5, 7, 9)  # square sizes with all MK*NK sums in each thread
CHUNK_ROWS = 8  # csrc/psf_grad.cu kChunkRows: tap rows per chunk, one per warp
COLS = 4  # csrc/psf_grad.cu kCols: adjacent error columns per item
MAX_STRIP = 512  # error columns per unit
SMEM_BUDGET = 44 * 1024  # csrc/psf_grad.cu kSmemBudget: stage bytes per block
launches = 0  # kernel launches by psf_gradient_planar (the twin never counts)


class Geometry(NamedTuple):
    inst: int  # MK (= NK) if unrolled, else 0 (run-time instance)
    tb: int  # column sums per tap row held in registers (>= NK)
    tr: int  # tap rows per unit: MK if unrolled, else CHUNK_ROWS
    ws: int  # error columns per strip, a multiple of COLS
    n_strips: int
    stage_w: int  # staged u columns per row: the strip and its window's reach
    band_rows: int  # error rows per band
    n_bands: int
    n_units: int  # C * tap-row chunks * bands * strips
    grid: int  # persistent blocks, at most per_sm on each SM
    smem: int  # stage bytes: stage_w floats x (band_rows + tr - 1) rows


def instance(mk: int, nk: int) -> tuple[int, int]:
    """(inst, tb): the template instance of K3 for (mk, nk) taps."""
    inst = mk if mk == nk and mk in UNROLLED else 0
    return inst, inst or next(t for t in (8, 16, 32) if nk <= t)


def geometry(c: int, m: int, n: int, mk: int, nk: int, sms: int, per_sm: int) -> Geometry:
    """The launch of K3 for err (c, m, n) and (mk, nk) taps on a card with
    ``sms`` SMs, ``per_sm`` blocks of the instance fitting on each: bands of
    rows short enough to give every block about one unit, and never more
    rows than the stage budget holds."""
    if mk < 1 or nk < 1 or nk > MAX_TAPS_SIDE:
        raise ValueError(f"K3 takes 1 <= NK <= {MAX_TAPS_SIDE}, any MK; got {mk}x{nk}")
    inst, tb = instance(mk, nk)
    tr = inst or CHUNK_ROWS
    n_chunks = -(-mk // tr)
    ws = min(-(-n // COLS) * COLS, MAX_STRIP)
    n_strips = -(-n // ws)
    stage_w = ws + 4 * -(-(COLS + tb - 1) // 4) - 4
    target = max(1, per_sm * sms)
    band_rows = -(-(c * n_chunks * n_strips * m) // target)
    band_rows = max(1, min(band_rows, SMEM_BUDGET // (4 * stage_w) - (tr - 1), m))
    n_bands = -(-m // band_rows)
    band_rows = -(-m // n_bands)  # the same bands, evened out
    n_units = c * n_chunks * n_bands * n_strips
    smem = 4 * stage_w * (band_rows + tr - 1)
    return Geometry(inst, tb, tr, ws, n_strips, stage_w, band_rows, n_bands, n_units,
                    min(n_units, target), smem)


_geometry = functools.lru_cache(maxsize=1024)(geometry)  # the solver repeats its shapes


@functools.lru_cache(maxsize=None)
def _card(index: int, inst: int, tb: int) -> tuple[int, int]:
    """(SMs, blocks of the instance per SM) of CUDA device ``index``."""
    import ctypes

    per_sm = ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(_build.load_library().ics_psf_grad_occupancy(
            ctypes.byref(per_sm), inst, tb), "ics_psf_grad_occupancy")
    if per_sm.value < 1:
        raise RuntimeError("K3: no block of its instance fits on an SM")
    return torch.cuda.get_device_properties(index).multi_processor_count, per_sm.value


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
    g = _geometry(c, m, n, mk, nk, *_card(u.device.index or 0, *instance(mk, nk)))
    partial = torch.empty(c * mk * nk * g.n_bands * g.n_strips, dtype=torch.float32,
                          device=u.device)
    out = torch.empty((c, mk, nk), dtype=torch.float32, device=u.device)
    rc = _build.load_library().ics_psf_grad(
        u.data_ptr(), err.data_ptr(), partial.data_ptr(), out.data_ptr(),
        c, u_m, u_n, m, n, g.inst, g.tb, g.tr, g.ws, g.n_strips, g.stage_w,
        g.band_rows, g.n_bands, g.grid, g.smem,
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
