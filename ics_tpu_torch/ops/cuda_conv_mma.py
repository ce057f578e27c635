"""K4s, K4, K4h and K4d: the banded tensor-core convolution
(csrc/conv_mma.cu) and its plain twins.

Counterpart of ics_tpu/ops/pallas_conv_mxu.py.  Planar (C, H, W) input,
(C, MK, NK) taps up to 31x31, scipy ``valid``/``same``/``full`` output.
Each replaces one instance of the TPU kernels there:

* K4s (``conv_split``, ``_make_split_kernel``, :118): float32 in and out,
  the bf16x3 emulation of f32 (``_split_hi_lo``: hi*hi + hi*lo + lo*hi, f32
  accumulation); about 1e-6 of the largest value from the exact f32
  convolution.
* K4 (``conv_bf16``, ``_make_kernel``, :170, bf16 operands): bfloat16
  operands, f32 accumulation, bfloat16 output rounded once.
* K4h (``conv_highest``, ``_make_kernel``, :170, f32 operands at
  ``lax.Precision.HIGHEST``): float32 in and out, each operand split into
  three bf16 slices that sum to it exactly and the six products HIGHEST
  runs on the MXU; f32-accurate (its twin sums the f32 convolution in
  float64).
* K4d (``conv_default``, ``_make_kernel``, :170, f32 operands at
  ``lax.Precision.DEFAULT``): float32 in and out, both operands rounded to
  bf16 (to nearest even), one product, f32 accumulation, no final rounding.

``conv_rgb_mxu`` is the counterpart of ``conv_rgb_pallas_mxu``: (H, W, C)
in and out, JAX's ``precision_name`` values.

On CPU tensors the wrappers run the plain twins; on CUDA tensors they launch
the kernel or raise.  ``geometry`` chooses each launch's template instance,
tile, grid and shared memory; the kernel refuses a geometry that does not
match its call.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ics_tpu_torch import _build
from ics_tpu_torch.ops.conv import _out_shape, _pads
from ics_tpu_torch.ops.cuda_conv import conv_planar_plain

__all__ = [
    "conv_split", "conv_split_plain", "conv_bf16", "conv_bf16_plain",
    "conv_highest", "conv_highest_plain", "conv_default", "conv_default_plain",
    "conv_rgb_mxu", "split_hi_lo", "MAX_TAPS_SIDE", "VARIANTS", "Geometry", "geometry",
    "smem_bytes",
]

MAX_TAPS_SIDE = 31  # csrc/conv_mma.cu kMaxK
TILE_W = 64  # output columns per tile (csrc/conv_mma.cu kTileW)
TILE_ROWS = (64, 32, 16)  # the tallest that gives every SM a tile
UNROLLED = (3, 5, 7, 9)  # MK = NK sizes with their own template instance
# the template's variant codes (csrc/conv_mma.cu kBf16 ... kDefault); True
# and False, as ints, name K4s and K4
VARIANTS = {"K4": 0, "K4s": 1, "K4h": 2, "K4d": 3}
_ENTRIES = {0: "ics_conv_mma_bf16", 1: "ics_conv_mma_split", 2: "ics_conv_mma_highest",
            3: "ics_conv_mma_default"}
SLICES = {0: 1, 1: 2, 2: 3, 3: 1}  # bf16 slices of each staged value
ENTRY_BYTES = {0: 8, 1: 16, 2: 16, 3: 8}  # bytes of one B table entry
SMEM_OPT_IN = 232448  # bytes of shared memory one block may use (227 KB)
SMEM_PER_SM = 233472  # bytes of shared memory per SM (228 KB), 1 KB reserved per block
THREADS_PER_SM = 512  # __launch_bounds__(256, 2): at most 128 registers a thread
split_launches = 0  # K4s launches by conv_split (the twin never counts)
bf16_launches = 0  # K4 launches by conv_bf16 (the twin never counts)
highest_launches = 0  # K4h launches by conv_highest (the twin never counts)
default_launches = 0  # K4d launches by conv_default (the twin never counts)


def split_hi_lo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo) bf16, as ics_tpu/ops/pallas_conv_mxu.py::_split_hi_lo:
    hi is x with its low 16 bits cleared (exact in bf16), lo = bf16(x - hi)."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi.to(torch.bfloat16), (x - hi).to(torch.bfloat16)


class Geometry(NamedTuple):
    inst: int  # template instance: MK (= NK) if unrolled, else 0 (run-time sizes)
    tile_rows: int  # output rows per tile, 16 a warp (f32 variants: two warps across)
    grid: int  # persistent blocks, at most one tile each per turn
    smem: int  # dynamic shared memory of one block, bytes
    n_tiles: int  # C * row tiles * column tiles


def _ksteps(nk: int) -> int:
    """m16n8k16 steps per 8-column block and tap row: 8 + nk - 1 columns."""
    return (8 + nk - 1 + 15) // 16


def smem_bytes(variant: int, inst: int, tile_rows: int, mk: int, nk: int) -> int:
    """Shared memory of one block, as csrc/conv_mma.cu::smem_bytes, in planes
    of (tile_rows + mk - 1) x (56 + 16 * steps) values: the f32 variants
    (K4s, K4h, K4d) two f32 ring slots and two slots of their bf16 slice
    tiles, each slot with its B table (an entry per tap row, k-step and
    lane: 16 bytes for K4s and K4h, 8 for K4d); K4 three bf16 ring slots,
    its staged outputs (tile_rows x 72 bf16) and, at run-time sizes, its B
    table (8-byte entries)."""
    plane = (tile_rows + mk - 1) * (TILE_W - 8 + 16 * _ksteps(nk))
    f32 = variant != VARIANTS["K4"]
    table = 0 if inst and not f32 else mk * _ksteps(nk) * 32 * ENTRY_BYTES[variant]
    if f32:
        return 2 * (4 + 2 * SLICES[variant]) * plane + 2 * table
    return 6 * plane + 2 * tile_rows * 72 + table


def geometry(variant: int, c: int, ho: int, wo: int, mk: int, nk: int, sms: int) -> Geometry:
    """The launch of ``variant`` (``VARIANTS``) for a (c, ho, wo) output and
    (mk, nk) taps on a card with ``sms`` SMs: the tallest tile whose block
    fits in shared memory and still gives every SM a tile, and as many
    persistent blocks as fit on the card at once, never more than the
    tiles."""
    inst = mk if mk == nk and mk in UNROLLED else 0
    n_ct = -(-wo // TILE_W)
    fits = [tr for tr in TILE_ROWS if smem_bytes(variant, inst, tr, mk, nk) <= SMEM_OPT_IN]
    for tile_rows in fits:
        n_tiles = c * -(-ho // tile_rows) * n_ct
        if n_tiles >= sms:
            break
    smem = smem_bytes(variant, inst, tile_rows, mk, nk)
    # warps across a tile, each 16 rows: the f32 variants two of four
    # 8-column blocks, K4 one of eight (csrc/conv_mma.cu warps_across)
    threads = 2 * (1 if variant == VARIANTS["K4"] else 2) * tile_rows
    per_sm = min(SMEM_PER_SM // (smem + 1024), THREADS_PER_SM // threads)
    return Geometry(inst, tile_rows, max(1, min(n_tiles, per_sm * sms)), smem, n_tiles)


_geometry = functools.lru_cache(maxsize=1024)(geometry)  # the pipeline repeats its shapes


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _conv_f64(a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """The convolution of float64 copies of ``a`` and ``k``, rounded to f32
    once."""
    plo, phi = _pads(k.shape[1], mode)
    qlo, qhi = _pads(k.shape[2], mode)
    padded = F.pad(a.double(), (qlo, qhi, plo, phi))
    w = torch.flip(k.double(), dims=(1, 2)).unsqueeze(1)
    return F.conv2d(padded.unsqueeze(0), w, groups=a.shape[0])[0].float()


def conv_highest_plain(a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain twin of K4h: the f32 convolution, summed in float64 and rounded
    once (K4h's slices sum to each operand exactly).  The float64 sum keeps
    the twin clear of the f32 error of cuDNN's own algorithm (0.6-1.7e-6 of
    the largest value on an H100), above the bound that tells K4h from
    K4s's bf16x3."""
    _check(a, k, mode, torch.float32)
    return _conv_f64(a, k, mode)


def conv_default_plain(a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain twin of K4d: both operands rounded to bf16 (to nearest even),
    then their convolution, summed in float64 and rounded to f32 once: a
    product of two bf16 values is exact, and the float64 sum keeps the twin
    clear of cuDNN's f32 error (1.3e-6 of the largest value at 31x31 on an
    H100, above the 1e-6 that K4d is held to)."""
    _check(a, k, mode, torch.float32)
    return _conv_f64(a.bfloat16(), k.bfloat16(), mode)


def _launch(variant: str, a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if not (a.is_contiguous() and k.is_contiguous()):
        raise ValueError(f"{variant} needs contiguous a and k")
    c, h, w = a.shape
    _, mk, nk = k.shape
    ho, wo = _out_shape(h, mk, mode), _out_shape(w, nk, mode)
    out = torch.empty((c, ho, wo), dtype=a.dtype, device=a.device)
    code = VARIANTS[variant]
    geo = _geometry(code, c, ho, wo, mk, nk, _sms(a.device.index))
    rc = getattr(_build.load_library(), _ENTRIES[code])(
        a.data_ptr(), k.data_ptr(), out.data_ptr(), c, h, w, mk, nk,
        _pads(mk, mode)[0], _pads(nk, mode)[0], ho, wo,
        geo.inst, geo.tile_rows, geo.grid, geo.smem,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, _ENTRIES[code])
    return out


def conv_split(a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """K4s on CUDA tensors, its plain twin on CPU ones (float32)."""
    global split_launches
    if a.device.type == "cpu":
        return conv_split_plain(a, k, mode)
    _check(a, k, mode, torch.float32)
    out = _launch("K4s", a, k, mode)
    split_launches += 1
    return out


def conv_bf16(a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """K4 on CUDA tensors, its plain twin on CPU ones (bfloat16)."""
    global bf16_launches
    if a.device.type == "cpu":
        return conv_bf16_plain(a, k, mode)
    _check(a, k, mode, torch.bfloat16)
    out = _launch("K4", a, k, mode)
    bf16_launches += 1
    return out


def conv_highest(a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """K4h on CUDA tensors, its plain twin on CPU ones (float32)."""
    global highest_launches
    if a.device.type == "cpu":
        return conv_highest_plain(a, k, mode)
    _check(a, k, mode, torch.float32)
    out = _launch("K4h", a, k, mode)
    highest_launches += 1
    return out


def conv_default(a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    """K4d on CUDA tensors, its plain twin on CPU ones (float32)."""
    global default_launches
    if a.device.type == "cpu":
        return conv_default_plain(a, k, mode)
    _check(a, k, mode, torch.float32)
    out = _launch("K4d", a, k, mode)
    default_launches += 1
    return out


# conv_rgb_pallas_mxu's precision_name -> ops/conv.py's precision
_PRECISION_NAMES = {"highest": "exact", "default": "fast", "bf16x3": "bf16x3"}


def conv_rgb_mxu(a: torch.Tensor, k: torch.Tensor, mode: str = "same",
                 precision: str = "highest") -> torch.Tensor:
    """Counterpart of ``conv_rgb_pallas_mxu``: the (H, W, C) image ``a``
    convolved per channel with ``k`` (MK, NK, C), or (MK, NK) broadcast,
    through ``convolve_rgb(method='pallas_mxu')``: K4h at ``'highest'``
    (its default, as HIGHEST is JAX's), K4d at ``'default'`` and K4s at
    ``'bf16x3'`` on float32 operands, K4 on bfloat16 ones.  Another dtype
    is cast to float32.  Taps over 31 a side take the direct convolution;
    over 129 wide raise ``ValueError``, as JAX's does."""
    from ics_tpu_torch.ops.conv import convolve_rgb

    if precision not in _PRECISION_NAMES:
        raise ValueError(f"unknown precision {precision!r} (use {', '.join(_PRECISION_NAMES)})")
    if a.dtype not in (torch.float32, torch.bfloat16):
        a = a.float()
    return convolve_rgb(a, k.to(a.dtype), mode, method="pallas_mxu",
                        precision=_PRECISION_NAMES[precision])
