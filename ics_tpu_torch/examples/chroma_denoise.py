"""Chromatic-noise removal with the collaborative RGB TV norms, on the port
(counterpart of examples/chroma_denoise.py).

Demonstrates the reference's headline mathematical contribution (ref
README.md:113-117: the collaborative L^{infinite,1,1} RGB total-variation
norm "acts as handcuffs between channels and helps dramatically in
chromatic noise removal", citing ipol.im/pub/art/2016/141) through the
MM solver's TV path: a delta PSF turns the solve into pure TV denoising,
isolating the regularizer.

Couplings compared (RLConfig.tv_norm):
  channel   — decoupled per-channel TV
  collab    — L^{inf,1,1}: per-pixel channel SUP (the reference's norm)
  collab_l2 — l2-color RMS coupling (Duran et al.'s l^{2,1,1} class)

    python -m ics_tpu_torch.examples.chroma_denoise [input] [output_dir] [--device cpu]

The default input is ``crop-original.jpg`` in the reference images'
directory (``--reference``, default ./img); any TIFF path works too.

Runs on a 256x256 crop, so it finishes in seconds.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ics_tpu_torch.models.rl_mm import RLConfig, richardson_lucy_MM
from ics_tpu_torch.utils.io import load_image, save
from ics_tpu_torch.utils.metrics import psnr, ssim


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("src", nargs="?", default=None)
    ap.add_argument("dest", nargs="?", default="out/chroma_denoise")
    ap.add_argument("--reference", default="img", help="the reference images' directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.dest, exist_ok=True)

    truth = load_image(args.src or os.path.join(args.reference, "crop-original.jpg"))
    truth = truth.astype(np.float32)
    truth /= truth.max()
    truth = (0.05 + 0.9 * truth[:256, :256]).astype(np.float32)

    # pure-chroma Gaussian noise: per-channel noise minus its luma part
    rng = np.random.default_rng(42)
    n = rng.normal(0, 0.08, truth.shape).astype(np.float32)
    noisy = np.clip(truth + n - n.mean(axis=2, keepdims=True), 0.02, 1).astype(np.float32)

    # delta PSF => the MM solve is pure TV denoising (regularizer only)
    delta = np.zeros((5, 5), np.float32)
    delta[2, 2] = 1.0
    psf = np.dstack([delta] * 3)
    u0 = np.pad(noisy, ((2, 2), (2, 2), (0, 0)), mode="edge")
    h, w = noisy.shape[:2]

    def chroma(a):
        return a - a.mean(axis=2, keepdims=True)

    def report(name, a):
        print(
            "%-10s SSIM %.4f  PSNR %6.2f  chroma-PSNR %6.2f"
            % (
                name,
                ssim(a, truth, data_range=1.0, device=args.device),
                psnr(a, truth, 1.0, device=args.device),
                psnr(chroma(a), chroma(truth), 1.0, device=args.device),
            )
        )
        save(np.clip(a, 0, 1) * 65535.0, "%s.tif" % name, args.dest)

    report("noisy", noisy)
    for tv_norm in ("channel", "collab", "collab_l2"):
        res = richardson_lucy_MM(
            noisy, u0, psf, 0, h, 0, w, 1e9,
            iterations=150, blind=False, lambd=100.0, step_factor=1e-3,
            config=RLConfig(use_tv=True, tv_norm=tv_norm), device=args.device,
        )
        report(tv_norm, np.clip(res.u.cpu().numpy(), 0, 1))
    print("outputs in", args.dest)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
