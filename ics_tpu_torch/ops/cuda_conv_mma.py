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
the kernel or raise.  ``geometry`` chooses each launch's template instance,
tile, grid and shared memory; the kernel refuses a geometry that does not
match its call.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ics_tpu_torch import _build
from ics_tpu_torch.ops.conv import _out_shape, _pads
from ics_tpu_torch.ops.cuda_conv import conv_planar_plain

__all__ = [
    "conv_split", "conv_split_plain", "conv_bf16", "conv_bf16_plain",
    "split_hi_lo", "MAX_TAPS_SIDE", "Geometry", "geometry", "smem_bytes",
]

MAX_TAPS_SIDE = 31  # csrc/conv_mma.cu kMaxK
TILE_W = 64  # output columns per tile (csrc/conv_mma.cu kTileW)
TILE_ROWS = (64, 32, 16)  # the tallest that gives every SM a tile
UNROLLED = (3, 5, 7, 9)  # MK = NK sizes with their own template instance
# warps across a tile, each 16 rows: K4s two of four 8-column blocks, K4 one
# of eight (csrc/conv_mma.cu warps_across)
WARPS_ACROSS = {True: 2, False: 1}
SMEM_OPT_IN = 232448  # bytes of shared memory one block may use (227 KB)
SMEM_PER_SM = 233472  # bytes of shared memory per SM (228 KB), 1 KB reserved per block
THREADS_PER_SM = 512  # __launch_bounds__(256, 2): at most 128 registers a thread
split_launches = 0  # K4s launches by conv_split (the twin never counts)
bf16_launches = 0  # K4 launches by conv_bf16 (the twin never counts)


def split_hi_lo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo) bf16, as ics_tpu/ops/pallas_conv_mxu.py::_split_hi_lo:
    hi is x with its low 16 bits cleared (exact in bf16), lo = bf16(x - hi)."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi.to(torch.bfloat16), (x - hi).to(torch.bfloat16)


class Geometry(NamedTuple):
    inst: int  # template instance: MK (= NK) if unrolled, else 0 (run-time sizes)
    tile_rows: int  # output rows per tile, 16 a warp (K4s: two warps across)
    grid: int  # persistent blocks, at most one tile each per turn
    smem: int  # dynamic shared memory of one block, bytes
    n_tiles: int  # C * row tiles * column tiles


def _ksteps(nk: int) -> int:
    """m16n8k16 steps per 8-column block and tap row: 8 + nk - 1 columns."""
    return (8 + nk - 1 + 15) // 16


def smem_bytes(split: bool, inst: int, tile_rows: int, mk: int, nk: int) -> int:
    """Shared memory of one block, as csrc/conv_mma.cu::smem_bytes, in planes
    of (tile_rows + mk - 1) x (56 + 16 * steps) values: K4s two f32 ring
    slots and two slots of hi and lo bf16 tiles, each with its B table (16
    bytes per tap row, k-step and lane); K4 three bf16 ring slots, its
    staged outputs (tile_rows x 72 bf16) and, at run-time sizes, its B table
    (8 bytes per tap row, k-step and lane)."""
    plane = (tile_rows + mk - 1) * (TILE_W - 8 + 16 * _ksteps(nk))
    table = 0 if inst and not split else mk * _ksteps(nk) * 32 * (16 if split else 8)
    if split:
        return 16 * plane + 2 * table
    return 6 * plane + 2 * tile_rows * 72 + table


def geometry(split: bool, c: int, ho: int, wo: int, mk: int, nk: int, sms: int) -> Geometry:
    """The launch of K4s (``split``) or K4 for a (c, ho, wo) output and
    (mk, nk) taps on a card with ``sms`` SMs: the tallest tile whose block
    fits in shared memory and still gives every SM a tile, and as many
    persistent blocks as fit on the card at once, never more than the
    tiles."""
    inst = mk if mk == nk and mk in UNROLLED else 0
    n_ct = -(-wo // TILE_W)
    fits = [tr for tr in TILE_ROWS if smem_bytes(split, inst, tr, mk, nk) <= SMEM_OPT_IN]
    for tile_rows in fits:
        n_tiles = c * -(-ho // tile_rows) * n_ct
        if n_tiles >= sms:
            break
    smem = smem_bytes(split, inst, tile_rows, mk, nk)
    threads = 2 * WARPS_ACROSS[split] * tile_rows
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


def _launch(entry: str, a: torch.Tensor, k: torch.Tensor, mode: str) -> torch.Tensor:
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if not (a.is_contiguous() and k.is_contiguous()):
        raise ValueError("K4 needs contiguous a and k")
    c, h, w = a.shape
    _, mk, nk = k.shape
    ho, wo = _out_shape(h, mk, mode), _out_shape(w, nk, mode)
    out = torch.empty((c, ho, wo), dtype=a.dtype, device=a.device)
    geo = _geometry(entry == "ics_conv_mma_split", c, ho, wo, mk, nk, _sms(a.device.index))
    rc = getattr(_build.load_library(), entry)(
        a.data_ptr(), k.data_ptr(), out.data_ptr(), c, h, w, mk, nk,
        _pads(mk, mode)[0], _pads(nk, mode)[0], ho, wo,
        geo.inst, geo.tile_rows, geo.grid, geo.smem,
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
