"""Generic utilities (counterpart of ics_tpu/utils/__init__.py; reference
lib/utils.py): window generators, filters (bilateral / bessel / gaussian /
USM), blending, colour operators, ``timeit`` and TIFF I/O, re-exported under
the JAX package's names; plus resize, tracing and ``metrics`` (SSIM, PSNR).
``enable_persistent_cache`` (the XLA compile cache) has no counterpart."""

from ics_tpu_torch.ops.windows import (
    uniform_kernel,
    gaussian_kernel,
    kaiser_kernel,
    poisson_kernel,
    disc_blur,
    lens_blur,
    gaussian_weight,
)
from ics_tpu_torch.utils.timing import timeit
from ics_tpu_torch.utils.filters import (
    bilateral_filter,
    bilateral_lab,
    bessel_blur,
    gaussian_blur,
    USM,
    overlay,
    blending,
    convolve,
)
from ics_tpu_torch.utils.color import (
    Lagrange_interpolation,
    LABImage,
    grey_point,
    auto_vibrance,
    divTV,
    gradTVEM,
    rgb_to_lab,
    lab_to_rgb,
    rgb_to_hsv,
    hsv_to_rgb,
)
from ics_tpu_torch.utils.io import save, load_image, imread, imread_sequence, imsave

__all__ = [
    "uniform_kernel",
    "gaussian_kernel",
    "kaiser_kernel",
    "poisson_kernel",
    "disc_blur",
    "lens_blur",
    "gaussian_weight",
    "timeit",
    "bilateral_filter",
    "bilateral_lab",
    "bessel_blur",
    "gaussian_blur",
    "USM",
    "overlay",
    "blending",
    "convolve",
    "Lagrange_interpolation",
    "LABImage",
    "rgb_to_lab",
    "lab_to_rgb",
    "rgb_to_hsv",
    "hsv_to_rgb",
    "grey_point",
    "auto_vibrance",
    "divTV",
    "gradTVEM",
    "save",
    "load_image",
    "imread",
    "imsave",
    "imread_sequence",
]
