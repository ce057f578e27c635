"""K2, the port's one-launch inner loop of a mask-window solve
(``csrc/inner_loop.cu``), launched once per outer by each call of
``ics_tpu_torch.models.rl_mm.inner_loop_planar`` on CUDA tensors.

The work of one call ``inner_loop_planar(u, image, psf, *, blind, ...)``,
planar float32 ``u`` (C, M + mk - 1, N + mk - 1), ``image`` (C, M, N) and
``psf`` (C, mk, mk): five inner steps, each with two convolutions of mk x mk
taps per image pixel (the residual, its correlation with the PSF) and two
more when blind (the fresh residual, the PSF gradient), about 10 operations
per image pixel and 9 per window pixel besides; ``u``, ``image`` and the PSF
read once, ``u`` and the residual written once, and the PSF when blind.
"""

NAME = "inner_loop_kernel"
CALL = ("ics_tpu_torch.models.rl_mm", "inner_loop_planar")
KIND = "f32"


def work(u, image, psf, *, blind, **_):
    """(operations, bytes) of one call: one outer."""
    c, mk = psf.shape[0], psf.shape[1]
    n_u, n_img = u.numel(), image.numel()
    convs = 4 if blind else 2
    ops = 5 * (convs * 2 * mk * mk * n_img + 10 * n_img + 9 * n_u)
    nbytes = 4 * (2 * n_u + 2 * n_img + (2 if blind else 1) * c * mk * mk)
    return ops, nbytes
