"""The traffic's frames: structured synthetic scenes, made on the device.

A frozen copy of ``ics_tpu_torch/utils/selftest.py::make_scene`` and
``_gauss_taps``, rewritten in torch so that a pool of 24 MP frames is made on
the card in a few calls: a gradient with a tint, 120 blocks with sharp edges,
a stripe pattern and blocky low-resolution noise, kept in [0.15, 0.9],
blurred by a separable Gaussian of the configuration's width (sigma = width
/ 4, edges replicated), plus Gaussian noise, quantised to 8 bits.  Never
uniform noise: the epsilon-free depth-of-field blend is chaotic on it.

The small draws (the tint, the blocks' places and sizes) come from a CPU
generator and the large ones (the cells, the noise) from one on the frame's
device, both seeded with the scene's seed: a seed gives the same frame on
the same device and torch build.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gauss_taps(width: int) -> torch.Tensor:
    """The 1-D Gaussian blur of ``width`` taps (sigma width / 4), summing to 1,
    in float64."""
    n = torch.arange(width, dtype=torch.float64) - (width - 1) / 2.0
    taps = torch.exp(-0.5 * (n / (width / 4.0)) ** 2)
    return taps / taps.sum()


def make_scene(h: int, w: int, blur: int, seed: int, device, noise: float = 0.002,
               blocks: int = 120) -> np.ndarray:
    """One blurred 8-bit (h, w, 3) frame, as a host array; the blur's
    convolutions run in float32 with TF32 off, whatever the flags say."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _scene(h, w, blur, seed, torch.device(device), noise, blocks)
    finally:
        torch.backends.cudnn.allow_tf32 = was


def _scene(h, w, blur, seed, dev, noise, blocks):
    host = torch.Generator().manual_seed(seed)
    card = torch.Generator(device=dev).manual_seed(seed)
    uniform = lambda lo, hi, shape, g=host, d="cpu": lo + (hi - lo) * torch.rand(
        shape, generator=g, device=d)
    integer = lambda lo, hi: int(torch.randint(lo, hi, (1,), generator=host))

    yy = torch.linspace(0.0, 1.0, h, device=dev)[:, None, None]
    xx = torch.linspace(0.0, 1.0, w, device=dev)[None, :, None]
    tint = uniform(-0.1, 0.1, (1, 1, 3)).to(dev)
    img = (0.35 + 0.25 * xx + 0.15 * yy + tint).expand(h, w, 3).contiguous()
    for _ in range(blocks):
        bh, bw = integer(h // 40, h // 6), integer(w // 40, w // 6)
        y0, x0 = integer(0, h - bh), integer(0, w - bw)
        img[y0:y0 + bh, x0:x0 + bw] += uniform(-0.25, 0.25, (3,)).to(dev)
    img += 0.04 * torch.sin(2 * np.pi * (xx * w / 37.0 + yy * h / 53.0))
    cells = uniform(-0.05, 0.05, (h // 8 + 1, w // 8 + 1, 3), card, dev)
    img += cells.repeat_interleave(8, 0).repeat_interleave(8, 1)[:h, :w]
    sharp = torch.clamp(img, 0.15, 0.9)

    taps = gauss_taps(blur).to(dev, torch.float32)
    r = blur // 2
    x = sharp.permute(2, 0, 1)[:, None]  # (3, 1, h, w)
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"), taps.view(1, 1, -1, 1))
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="replicate"), taps.view(1, 1, 1, -1))
    blurred = x[:, 0].permute(1, 2, 0)
    blurred = blurred + noise * torch.randn(blurred.shape, generator=card, device=dev)
    frame = torch.round(torch.clamp(blurred, 0.0, 1.0) * 255.0).to(torch.uint8)
    return frame.cpu().numpy()


def pool(h: int, w: int, blur: int, seeds, device, **scene) -> list[np.ndarray]:
    """One frame per scene seed."""
    return [make_scene(h, w, blur, int(s), device, **scene) for s in seeds]
