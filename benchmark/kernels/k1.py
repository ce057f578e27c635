"""K1, the port's per-channel 2-D convolution (``csrc/conv2d.cu``), launched
once by each call of ``ics_tpu_torch.ops.cuda_conv.conv_planar`` on CUDA
tensors.

The work of one call ``conv_planar(a, k, mode)``, planar float32 ``a`` (C, H,
W) and taps ``k`` (C, MK, NK): every product of an input pixel and a tap that
lands on an output pixel, two operations each, and each input, tap and
output byte moved once.
"""

NAME = "conv2d_kernel"  # the kernel's name in the device trace
CALL = ("ics_tpu_torch.ops.cuda_conv", "conv_planar")
KIND = "f32"


def _pads(k: int, mode: str) -> tuple[int, int]:
    """(low pad, output length minus input length) of one axis."""
    return {"valid": (0, 1 - k), "same": (k // 2, 0), "full": (k - 1, k - 1)}[mode]


def _pairs(n: int, k: int, mode: str) -> tuple[int, int]:
    """(input-tap products, output length) along one axis of length ``n``."""
    lo, grow = _pads(k, mode)
    out = n + grow
    pairs = sum(max(0, min(out, lo - t + n) - max(0, lo - t)) for t in range(k))
    return pairs, out


def work(a, k, mode):
    """(operations, bytes) of one call."""
    c, h, w = a.shape
    _, mk, nk = k.shape
    rows, ho = _pairs(h, mk, mode)
    cols, wo = _pairs(w, nk, mode)
    return 2 * c * rows * cols, 4 * (c * h * w + c * mk * nk + c * ho * wo)
