"""ICS on PyTorch and CUDA: the port of ``ics_tpu`` to an NVIDIA H100.

The JAX package ``ics_tpu`` stays the reference; this package mirrors its
layout (``ops/``, ``models/``, ``utils/``) and names, imports ``torch`` and
never ``jax`` or ``ics_tpu``.  It runs ``deblur_module`` with the ``mm``
solver in every precision mode and with the ``use_tv`` regularizer, carried
on the GPU by hand-written CUDA kernels (``csrc/``): the per-channel
convolution (K1), the one-launch RL-MM inner loop (K2), the blind PSF
gradient (K3), the bf16 tensor-core convolutions, split-f32 (K4s) and bf16
(K4), and the TV stencil (K5).  Each kernel has a plain PyTorch twin that
runs on CPU tensors.

Public surface of this slice:
  - ``deblur_module``      (reference: deconvolve.py:66)
  - ``richardson_lucy_MM`` (reference: lib/deconvolution.pyx:341)
  - ``normalize_kernel``   (reference: lib/deconvolution.pyx:73)
"""

from ics_tpu_torch.ops.windows import uniform_kernel, gaussian_kernel
from ics_tpu_torch.ops.psf import normalize_kernel, rotate_180
from ics_tpu_torch.ops.conv import convolve2d, convolve_rgb
from ics_tpu_torch.models.rl_mm import richardson_lucy_MM, RLConfig, RLResult
from ics_tpu_torch.models.pipeline import deblur_module, build_pyramid, pad_image

__version__ = "0.1.0"

__all__ = [
    "uniform_kernel",
    "gaussian_kernel",
    "normalize_kernel",
    "rotate_180",
    "convolve2d",
    "convolve_rgb",
    "richardson_lucy_MM",
    "RLConfig",
    "RLResult",
    "deblur_module",
    "build_pyramid",
    "pad_image",
]
