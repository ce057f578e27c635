"""Device selection and the exact-float32 switch.

Every public entry of the port takes an explicit ``device``.  Asking for
CUDA on a machine without a GPU raises; nothing falls back to the CPU.

``exact_f32`` is the counterpart of ``lax.Precision.HIGHEST`` in the JAX
solver (ics_tpu/models/rl_mm.py:313-317): PyTorch lets cuDNN run float32
convolutions in TF32 by default, which keeps about three decimal digits and
breaks the parity class of the epsilon-free DoF division.
"""

from __future__ import annotations

import torch

__all__ = ["exact_f32", "resolve_device", "synchronize"]


def exact_f32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions (the one place)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names an absent GPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device queue (no-op on the CPU, which runs eagerly)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
