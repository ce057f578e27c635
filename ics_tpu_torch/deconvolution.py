"""Reference-compatible module path: ``ics_tpu_torch.deconvolution`` mirrors
the reference's ``lib.deconvolution`` public surface, as
``ics_tpu.deconvolution`` does:

    from lib import deconvolution as dc            # reference
    from ics_tpu_torch import deconvolution as dc  # this port
"""

from ics_tpu_torch.models.rl_mm import RLConfig, RLResult, richardson_lucy_MM
from ics_tpu_torch.ops.psf import normalize_kernel, rotate_180

__all__ = [
    "richardson_lucy_MM",
    "normalize_kernel",
    "rotate_180",
    "RLConfig",
    "RLResult",
]
