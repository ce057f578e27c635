"""Checkpoint of the estimated PSF (copy of ics_tpu/models/checkpoint.py).

The same ``.npz`` format, so a PSF that ``ics_tpu`` saved loads here and the
other way round.  Host-side NumPy, copied because the port never imports
``ics_tpu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SolverCheckpoint", "save_checkpoint", "load_checkpoint"]

_FORMAT_VERSION = 1


@dataclasses.dataclass
class SolverCheckpoint:
    psf: np.ndarray  # (MK, MK, 3) estimated PSF
    u: np.ndarray | None = None  # current deconvolved iterate (optional)
    blur_width: int | None = None
    iterations_done: int = 0
    M_r: float = 0.0
    phase: str = "blind"  # 'blind' | 'non-blind'

    def __post_init__(self):
        self.psf = np.asarray(self.psf, np.float32)
        if self.u is not None:
            self.u = np.asarray(self.u, np.float32)


def save_checkpoint(path: str, ckpt: SolverCheckpoint) -> None:
    payload = {
        "format_version": _FORMAT_VERSION,
        "psf": ckpt.psf,
        "iterations_done": ckpt.iterations_done,
        "M_r": ckpt.M_r,
        "phase": ckpt.phase,
    }
    if ckpt.u is not None:
        payload["u"] = ckpt.u
    if ckpt.blur_width is not None:
        payload["blur_width"] = ckpt.blur_width
    np.savez_compressed(path, **payload)


def load_checkpoint(path: str) -> SolverCheckpoint:
    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version > _FORMAT_VERSION:
            raise ValueError(f"checkpoint format {version} is newer than supported")
        return SolverCheckpoint(
            psf=z["psf"],
            u=z["u"] if "u" in z else None,
            blur_width=int(z["blur_width"]) if "blur_width" in z else None,
            iterations_done=int(z["iterations_done"]),
            M_r=float(z["M_r"]),
            phase=str(z["phase"]),
        )
