"""Fixtures of the port's parallel tests (tests/test_torch_parallel.py,
tests/test_torch_distributed.py): the shapes of tests/test_sharding.py's,
made smooth.  The DoF division of the reference's solver has no epsilon, so
uniform noise makes two correct orders of the same sums diverge; smooth
content keeps a cross-framework comparison inside float32 noise."""

import numpy as np
import scipy.signal as sig

from ics_tpu_torch.ops.windows import gaussian_kernel, uniform_kernel


def smooth(rng, h, w):
    """Noise under a 9-tap Gaussian (sigma 2), clipped to [0.2, 0.9]: the
    fixture of tests/test_sharding.py:40-50."""
    base = rng.random((h + 8, w + 8, 3))
    k = gaussian_kernel(9, 2.0)
    s = np.stack([sig.convolve(base[..., c], k, mode="valid") for c in range(3)], axis=-1)
    return np.clip(s[:h, :w], 0.2, 0.9)


def padded(images, pad):
    """Each (m, m, 3) image edge-padded by ``pad``: the solver's u."""
    return np.stack([np.pad(im, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
                     for im in images]).astype(np.float32)


def lanes(seed, b, m, mk, contrast=None):
    """``b`` smooth (m, m, 3) lanes with their u and uniform PSFs, and the
    solver's mask box.  ``contrast``: lane i spans 0.2 + contrast * i of
    the range, so that the lanes' whiteness stops fall apart."""
    rng = np.random.default_rng(seed)
    images = []
    for i in range(b):
        s = smooth(rng, m, m)
        if contrast is not None:
            s = (s - s.min()) / (s.max() - s.min())
            s = np.clip(0.15 + s * (0.2 + contrast * i), 0.1, 0.95)
        images.append(s)
    images = np.stack(images).astype(np.float32)
    pad = mk // 2
    psfs = np.stack([np.dstack([uniform_kernel(mk)] * 3)] * b).astype(np.float32)
    return images, padded(images, pad), psfs, (pad + 1, m - pad - 1, pad + 1, m - pad - 1)
