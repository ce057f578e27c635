"""ICS on PyTorch and CUDA: the port of ``ics_tpu`` to an NVIDIA H100.

The JAX package ``ics_tpu`` stays the reference; this package mirrors its
layout (``ops/``, ``models/``, ``utils/``) and names, imports ``torch`` and
never ``jax`` or ``ics_tpu``.  It runs ``deblur_module`` with the ``mm``
solver in every precision mode and with the ``use_tv`` regularizer, and with
the TV-PAM and TV-PD solvers; the classic filters (``utils/filters.py``), TV
denoising, the colour operators (``utils/color.py``), SSIM and PSNR
(``utils/metrics.py``), TIFF I/O and the command line (``python -m
ics_tpu_torch``), carried on the
GPU by hand-written CUDA kernels (``csrc/``): the per-channel convolution
(K1), the one-launch RL-MM inner loop (K2), the blind PSF gradient (K3), the
bf16 tensor-core convolutions, split-f32 (K4s) and bf16 (K4), the TV stencil
(K5) and the bilateral filter (K6).  Each kernel has a plain PyTorch twin
that runs on CPU tensors.

Public surface of this slice:
  - ``deblur_module``      (reference: deconvolve.py:66)
  - ``richardson_lucy_MM`` (reference: lib/deconvolution.pyx:341), and
    the solver families ``richardson_lucy_PAM`` and ``richardson_lucy_PD``
  - ``normalize_kernel``   (reference: lib/deconvolution.pyx:73)
  - ``tv_denoise`` and the ``utils`` modules ``filters``, ``color``,
    ``metrics`` and ``io`` (reference: lib/utils.py)
  - ``ics_tpu_torch.parallel``: batched deconvolution of a burst and the
    row-sharded solve over many ranks (``deblur_module(mesh=...)``)
  - ``ics_tpu_torch.runtime``: the native C++ host tier (the LZW and
    PackBits TIFF coders, the thread-pool file prefetcher), built with the
    host compiler at first use
  - ``ics_tpu_torch.utils.selftest``: ``certify_kernels`` (every kernel
    against its twin on the card), the conv and scaling benches, the
    blind-restoration success and precision-quality batteries
  - ``ics_tpu_torch.examples``: the four examples, ``python -m
    ics_tpu_torch.examples.<name>``
"""

from ics_tpu_torch.ops.windows import (
    uniform_kernel,
    gaussian_kernel,
    kaiser_kernel,
    poisson_kernel,
    disc_blur,
    lens_blur,
)
from ics_tpu_torch.ops.psf import normalize_kernel, rotate_180
from ics_tpu_torch.ops.conv import convolve2d, convolve_rgb
from ics_tpu_torch.models.rl_mm import richardson_lucy_MM, RLConfig, RLResult
from ics_tpu_torch.models.rl_pam import richardson_lucy_PAM, PAMConfig
from ics_tpu_torch.models.rl_pd import richardson_lucy_PD, PDConfig
from ics_tpu_torch.models.tv_denoise import tv_denoise
from ics_tpu_torch.models.pipeline import deblur_module, build_pyramid, pad_image

__version__ = "0.1.0"

__all__ = [
    "uniform_kernel",
    "gaussian_kernel",
    "kaiser_kernel",
    "poisson_kernel",
    "disc_blur",
    "lens_blur",
    "normalize_kernel",
    "rotate_180",
    "convolve2d",
    "convolve_rgb",
    "richardson_lucy_MM",
    "RLConfig",
    "RLResult",
    "richardson_lucy_PAM",
    "PAMConfig",
    "richardson_lucy_PD",
    "PDConfig",
    "tv_denoise",
    "deblur_module",
    "build_pyramid",
    "pad_image",
]
