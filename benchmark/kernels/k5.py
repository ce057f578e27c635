"""K5, the port's TV stencil (``csrc/tv.cu``), launched once by each call of
``ics_tpu_torch.ops.cuda_tv.tv_planar`` on CUDA tensors.

The work of one call ``tv_planar(u, epsilon, order, norm)``, planar ``u`` (C,
H, W): each interior pixel's differences, magnitude and divergence (order 2:
28 operations with the L1 norm, 30 with L2; order 1: 40 and 44, as the plain
twin writes them), ``u`` read once and the magnitude and the divergence
written once, in ``u``'s dtype.
"""

NAME = "tv_kernel"  # the kernel's name in the device trace
CALL = ("ics_tpu_torch.ops.cuda_tv", "tv_planar")
KIND = "f32"
OPS = {(2, 1): 28, (2, 2): 30, (1, 1): 40, (1, 2): 44}  # per interior pixel, by (order, norm)


def work(u, epsilon, order=2, norm=1):
    """(operations, bytes) of one call."""
    c, h, w = u.shape
    return OPS[(order, norm)] * c * (h - 2) * (w - 2), 3 * u.numel() * u.element_size()
