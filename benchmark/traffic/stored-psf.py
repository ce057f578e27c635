"""Set-up of the mix ``stored-psf``: the PSF that every frame is deblurred
from, written once.

It is the scenes' true blur (``scenes.gauss_taps`` of the configuration's
``blur_width``, sigma width / 4): the outer product of the taps with
themselves, the same for the three channels, float32, in the port's
checkpoint format (``format_version``, ``psf``, ``blur_width``,
``iterations_done``, ``M_r``, ``phase``), as ``deblur --save-psf`` writes it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from benchmark import scenes

FORMAT_VERSION = 1


def true_psf(width: int) -> np.ndarray:
    """The (width, width, 3) float32 Gaussian that blurred the scenes."""
    taps = scenes.gauss_taps(width).numpy()
    return np.repeat(np.outer(taps, taps)[:, :, None], 3, axis=2).astype(np.float32)


def prepare(cell, directory: Path) -> dict:
    """Write the PSF of ``cell``'s configuration into ``directory``; the
    frames' kwargs then name it."""
    path = directory / "psf.npz"
    psf = true_psf(cell.config["kwargs"]["blur_width"])
    np.savez_compressed(path, format_version=FORMAT_VERSION, psf=psf,
                        blur_width=psf.shape[0], iterations_done=0, M_r=0.0, phase="blind")
    return {"psf_path": str(path)}
