"""Runnable example cases mirroring the reference's __main__ experiment block
(ref deconvolve.py:370-423), on the port (counterpart of
examples/deblur_cases.py).  Run one with

    python -m ics_tpu_torch.examples.deblur_cases crop
    python -m ics_tpu_torch.examples.deblur_cases crop --input frame.tif --dest out/

Each case reads its image from the reference images' directory
(``--reference``, default ./img); ``--input`` reads another image (a TIFF
where PIL is absent), and ``--mask``, ``--mask-size`` and ``--iterations``
override the case's, for small inputs.  ``--device cpu`` runs it without a
GPU.
"""

from __future__ import annotations

import argparse
import os

from ics_tpu_torch import deblur_module
from ics_tpu_torch.utils.io import load_image

SOURCE = "img"
DEST = "out/richardson-lucy-deconvolution"

# name: (the case's image, its output name, deblur_module's blur width and kwargs)
CASES = {
    # the published benchmark case: blind TV-MM on blured.jpg
    # (ref deconvolve.py:382-386; README.md:139-144)
    "blured": ("blured.jpg", "blured-v1", 7, dict(
        mask=[584, 795], tolerance=0.1, quality="normal", preview=False, blur="static",
        iterations=200)),
    # small non-blind-friendly crop (BASELINE.json config 3)
    "crop": ("crop-blured.jpg", "crop-blured-v1", 7, dict(
        mask_size=255, tolerance=0.1, iterations=100)),
    # large-image preview run with a chosen mask (ref deconvolve.py:412-416)
    "153412": ("153412.jpg", "153412-v1", 9, dict(
        mask=[1800, 3650], mask_size=811, preview=True, tolerance=100.0, iterations=100)),
    # motion-blur mode: PSF channels tied together (ref deconvolve.py:376-378)
    "motion": ("blured.jpg", "blured-motion-v1", 7, dict(
        mask=[584, 795], blur="motion", tolerance=0.1, iterations=200)),
}


def run_case(name: str, source: str | None = None, dest: str = DEST, device="cuda",
             reference: str = SOURCE, **override):
    """Run case ``name`` on ``source`` (default: the case's own image in
    ``reference``) and write ``<dest>/<output name>.tif``; returns the
    16-bit array."""
    image, out_name, blur_width, kw = CASES[name]
    pic = load_image(source or os.path.join(reference, image))
    os.makedirs(dest, exist_ok=True)
    return deblur_module(pic, out_name, dest, blur_width, display=False, device=device,
                         **{**kw, **override})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("case", nargs="?", default="crop", choices=list(CASES))
    ap.add_argument("--input", default=None, help="image to run the case on")
    ap.add_argument("--dest", default=DEST)
    ap.add_argument("--reference", default=SOURCE, help="the reference images' directory")
    ap.add_argument("--mask", type=int, nargs=2, default=None, metavar=("ROW", "COL"))
    ap.add_argument("--mask-size", type=int, default=None)
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    override = {k: v for k, v in (("mask", args.mask), ("mask_size", args.mask_size),
                                  ("iterations", args.iterations)) if v is not None}
    run_case(args.case, args.input, args.dest, args.device, args.reference, **override)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
