"""Solvers: TV-MM, TV-PAM and TV-PD deconvolution, the deblur pipeline, TV
denoising and PSF checkpoints (the counterpart of ics_tpu/models/__init__.py)."""

from ics_tpu_torch.models.rl_mm import RLConfig, RLResult, richardson_lucy_MM
from ics_tpu_torch.models.rl_pam import PAMConfig, richardson_lucy_PAM
from ics_tpu_torch.models.rl_pd import PDConfig, richardson_lucy_PD
from ics_tpu_torch.models.pipeline import build_pyramid, deblur_module, pad_image
from ics_tpu_torch.models.tv_denoise import tv_denoise
from ics_tpu_torch.models.checkpoint import (
    SolverCheckpoint,
    load_checkpoint,
    save_checkpoint,
)

__all__ = [
    "RLConfig",
    "RLResult",
    "richardson_lucy_MM",
    "PAMConfig",
    "richardson_lucy_PAM",
    "PDConfig",
    "richardson_lucy_PD",
    "build_pyramid",
    "deblur_module",
    "pad_image",
    "tv_denoise",
    "SolverCheckpoint",
    "load_checkpoint",
    "save_checkpoint",
]
