"""The least time an H100 could take for a kernel's work: a frozen copy of
``ics_tpu_torch/utils/selftest.py``'s ``_bound`` and its table of peaks.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: HBM3 at 3.35 TB/s, 67 TFLOP/s in float32 outside the
tensor cores, 989 TFLOP/s in bf16.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12}


def bound_s(ops: float, nbytes: float, kind: str = "f32") -> float:
    """The larger of the bytes over the memory rate and the operations over
    the peak rate of their type, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])
