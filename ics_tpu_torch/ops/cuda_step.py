"""K8, the MM step (csrc/mm_step.cu): steps 4-8 of the op loop's inner
iteration in parity mode, and its plain twin.

Replaces no TPU kernel: XLA fuses these steps of the ``lax.scan`` body of
ics_tpu/models/rl_mm.py:377-531.  ``ops/cuda_solver.py::inner_loop_ops``
takes ``mm_step`` as its ``step`` backend where the solver routes it
(``models/rl_mm.py::mm_step_route``): the depth-of-field weights, ``greg``,
the per-channel step and the blend of the inner crop, in two launches
bitwise equal to the PyTorch ops of ``mm_step_plain`` on the card.  On a
CPU tensor ``mm_step`` runs the twin; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ics_tpu_torch import _build

__all__ = ["geometry", "mm_step", "mm_step_plain"]

THREADS = 256  # csrc/mm_step.cu kThreads
BLOCKS_PER_SM = 4  # one wave of resident blocks at the passes' 38-48 registers
launches = 0  # kernel launches by mm_step, two a call (the twin never counts)


def _shapes(u, ut, gradu, image) -> tuple[int, int, int, int, int, int]:
    """(C, uM, uN, M, N, pad): the window, the image and the inner crop's
    offset, ``(uM - M) // 2`` on both axes as in ``inner_loop_ops``."""
    if u.ndim != 3 or image.ndim != 3:
        raise ValueError(f"expected planar (C, H, W) tensors, got {tuple(u.shape)} and "
                         f"{tuple(image.shape)}")
    c, u_m, u_n = u.shape
    _, m, n = image.shape
    pad = (u_m - m) // 2
    if ut.shape != u.shape or gradu.shape != u.shape or image.shape[0] != c or pad < 0 \
            or pad + n > u_n:
        raise ValueError(
            f"the MM step takes u, ut and gradu (C, uM, uN) and image (C, M, N) inside "
            f"them; got {tuple(u.shape)}, {tuple(ut.shape)}, {tuple(gradu.shape)}, "
            f"{tuple(image.shape)}"
        )
    return c, u_m, u_n, m, n, pad


def mm_step_plain(u, ut, gradu, image, *, step_factor, lambd, blind):
    """Plain twin: steps 4-8 of ``inner_loop_ops`` in parity mode (no DoF
    guard, no TV, one device), the same PyTorch ops.  ``gradu`` is the full
    correlation of the residual with the PSF; returns the new ``u``."""
    _, u_m, u_n, m, n, pad = _shapes(u, ut, gradu, image)
    crop = (slice(None), slice(pad, pad + m), slice(pad, pad + n))
    sf = torch.full((), step_factor, dtype=torch.float32, device=u.device)
    gcrop = gradu[crop]
    dof = ((gcrop - image) / (gcrop + image)) ** 2
    if not blind:
        dof = dof / lambd
    greg = lambd * gradu + (u - ut) / 2.0
    u_max, greg_max = (torch.amax(x, dim=(1, 2)) for x in (u, torch.abs(greg)))
    dt = sf * (u_max + 1.0 / (u_m * u_n)) / (greg_max + 1e-15)
    u = u - dt[:, None, None] * greg
    u[crop] = (1.0 - dof) * u[crop] + dof * image
    return u


def geometry(channels: int, plane: int, sms: int) -> tuple[int, int]:
    """(blocks per channel, elements per block) of K8's launches over
    ``channels`` planes of ``plane`` elements on ``sms`` SMs: one wave of
    resident blocks, or fewer where a block would get less than one 16-byte
    group a thread; each block's chunk a multiple of 4, the last one
    holding the rest of the plane."""
    blocks = min(math.ceil(plane / (THREADS * 4)),
                 max(1, math.ceil(sms * BLOCKS_PER_SM / channels)))
    chunk = math.ceil(plane / blocks / 4) * 4
    return math.ceil(plane / chunk), chunk


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def mm_step(u, ut, gradu, image, *, step_factor, lambd, blind):
    """K8 on contiguous float32 CUDA tensors (a fresh output; ``ut`` may be
    ``u``), the plain twin on CPU ones: the new ``u`` after steps 4-8."""
    global launches
    if u.device.type == "cpu":
        return mm_step_plain(u, ut, gradu, image, step_factor=step_factor, lambd=lambd,
                             blind=blind)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    tensors = (u, ut, gradu, image)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("K8 takes float32 only")
    if any(t.device != u.device for t in tensors):
        raise ValueError("u, ut, gradu and image must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K8 needs contiguous planar tensors")
    c, u_m, u_n, m, n, pad = _shapes(u, ut, gradu, image)
    if u_m * u_n >= 2**30:
        raise ValueError(f"K8 takes planes below 2**30 elements: {tuple(u.shape)}")
    # the kernel's 16-byte loads need the window tensors to start on 16
    # bytes, as every allocation does; a view that does not is copied
    u, ut, gradu = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (u, ut, gradu))
    out = torch.empty_like(u)
    blocks, chunk = geometry(c, u_m * u_n, _sms(u.device.index or 0))
    partial = torch.empty(c * blocks * 2, dtype=torch.float32, device=u.device)
    f32 = np.float32
    # as PyTorch rounds its Python scalars on the card: a division by one is a
    # product with its reciprocal, taken in float64 (inf for 0), then rounded
    with np.errstate(divide="ignore"):
        inv_lambd = f32(np.float64(1.0) / lambd)
    rc = _build.load_library().ics_mm_step(
        gradu.data_ptr(), u.data_ptr(), ut.data_ptr(), image.data_ptr(), out.data_ptr(),
        partial.data_ptr(), c, u_m, u_n, m, n, pad, blocks, chunk,
        float(f32(lambd)), float(inv_lambd), float(f32(step_factor)),
        float(f32(1.0 / (u_m * u_n))), float(f32(1e-15)), int(bool(blind)),
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    _build.check(rc, "ics_mm_step")
    launches += 2
    return out
