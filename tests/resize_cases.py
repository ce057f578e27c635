"""The resizes of a blind ``deblur_module`` frame at the benchmark's two
deployments (tests/test_torch_resize.py on the CPU, tests/test_torch_cuda.py
on the card): each pyramid level resizes the frame and the running estimate
to the level's shape, and the PSF to the level's size.  Imports neither JAX
nor ``ics_tpu``."""

import numpy as np

from ics_tpu_torch.models.pipeline import build_pyramid

# frame rows, columns and blur width: the 24 MP and the 1.9 MP cells
CELLS = {"cam24": (4000, 6000, 9), "ref19": (1367, 1394, 7)}


def _odd(n: int) -> int:
    return n + (n % 2 == 0)


def calls(rows: int, cols: int, blur: int) -> list[tuple[tuple, tuple]]:
    """(input shape, output rows and columns) of each resize of the blind
    levels that changes a size, in the pipeline's order (the non-blind
    levels resize the frame and their estimate to the same shapes again)."""
    m, n = rows + 2, cols + 2  # the preprocess pads one pixel each side
    frame = (_odd(m), _odd(n))  # then an even side gets one more
    scales, sizes = build_pyramid(blur)
    out, estimate, psf = [], frame, blur
    for scale, k in zip(reversed(scales), reversed(sizes)):
        shape = (_odd(int(np.floor(scale * m))), _odd(int(np.floor(scale * n))))
        out += [((*src, 3), shape) for src in (frame, estimate) if src != shape]
        if psf != k:
            out.append(((psf, psf, 3), (k, k)))
        estimate, psf = shape, k
    return out


def passes(rows: int, cols: int, blur: int) -> list[tuple[tuple, int, int]]:
    """(input shape, axis, output size) of each pass of ``calls``: the rows,
    then the columns."""
    out = []
    for shape, (h, w) in calls(rows, cols, blur):
        if shape[0] != h:
            out.append((shape, 0, h))
        if shape[1] != w:
            out.append(((h, *shape[1:]), 1, w))
    return out


def axes() -> list[tuple[int, int]]:
    """Every distinct (input size, output size) of both cells' passes."""
    return sorted({(shape[axis], n) for cell in CELLS.values()
                   for shape, axis, n in passes(*cell)})
