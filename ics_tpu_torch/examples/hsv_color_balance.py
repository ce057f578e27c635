"""HSV color-balance example, the workflow of the reference's
``notebooks/HSV color balance.ipynb``, on the port (counterpart of
examples/hsv_color_balance.py): push the global hue toward a target, then
shift hue/saturation selectively in shadows / midtones / highlights using
Gaussian luminance masks.

    python -m ics_tpu_torch.examples.hsv_color_balance [input] [output_dir] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ics_tpu_torch.utils.color import (
    hsv_to_rgb,
    hue_shift,
    luma_masks,
    normal2rad,
    rad2normal,
    rgb_to_hsv,
    saturation_boost,
)
from ics_tpu_torch.utils.io import load_image, save


def color_balance(
    rgb,
    main_hue=np.pi / 6,
    high_hue=np.pi / 3,
    mid_hue=4.2 - 2 * np.pi,
    low_hue=4.2 - 2 * np.pi,
    amount=1.0,
    sat_high=0.2,
    sat_mid=0.1,
    sat_low=0.0,
    device="cuda",
):
    """The notebook's full pipeline on an (H, W, 3) [0,1] image, on ``device``."""
    hsv = rgb_to_hsv(rgb, device=device)
    h = normal2rad(hsv[..., 0])
    s = hsv[..., 1]
    v = hsv[..., 2]

    low, mid, high = luma_masks(v)
    h = hue_shift(h, main_hue, amount)
    h = hue_shift(h, high_hue, amount) * high + hue_shift(h, mid_hue, amount) * mid \
        + hue_shift(h, low_hue, amount) * low
    s = saturation_boost(s, sat_high) * high + saturation_boost(s, sat_mid) * mid \
        + saturation_boost(s, sat_low) * low
    s = torch.clamp(s, 0.0, 1.0)

    out = hsv_to_rgb(torch.stack([rad2normal(h), s, v], dim=-1))
    return torch.clamp(out, 0.0, 1.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("src", nargs="?", default=None)
    ap.add_argument("dest", nargs="?", default="out")
    ap.add_argument("--reference", default="img", help="the reference images' directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.src = args.src or os.path.join(args.reference, "153412-crop.jpg")
    pic = np.asarray(load_image(args.src), np.float32) / 255.0
    out = color_balance(pic, device=args.device).cpu().numpy()
    os.makedirs(args.dest, exist_ok=True)
    name = os.path.splitext(os.path.basename(args.src))[0] + "-hue-shift"
    save(out * (2**16 - 1), name, args.dest)
    print("saved", os.path.join(args.dest, name + ".tif"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
