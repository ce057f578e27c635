"""Multi-GPU deblurring: split the full-frame non-blind solves by rows over
N ranks, on the port (counterpart of examples/shard_deblur.py).

    python -m ics_tpu_torch.examples.shard_deblur frame.tif out/ --shard 4

The blind PSF estimation runs whole on every rank (it solves a few-hundred-
pixel mask window); each full-frame non-blind pyramid level splits its rows
over the ranks (``ics_tpu_torch.parallel.sharded_richardson_lucy``): halo
rows go to the neighbours before each convolution, and the solver's
per-channel reductions become all-reduces.  ``--shard N`` starts N ranks,
one process each, as the CLI's ``deblur --shard N`` does: NCCL with a GPU
each on CUDA (``--shard 0``, the default, takes every GPU), gloo on the CPU
with ``--device cpu`` (default one rank):

    python -m ics_tpu_torch.examples.shard_deblur frame.tif out/ --shard 4 --device cpu

The JAX example turns on XLA's persistent compile cache first; the port
has nothing to compile per shape, and ``enable_persistent_cache`` keeps the
directory where its kernels and runtime are built once per source hash
(``ics_tpu_torch/_build/`` unless a caller named another).
"""

from __future__ import annotations

import argparse
import os

import torch

from ics_tpu_torch.cli import _check_shard, _spawn


def _deblur(args, device, mesh) -> int:
    """One rank's run (spawned by ``_spawn``); rank 0 prints and writes."""
    from ics_tpu_torch import deblur_module
    from ics_tpu_torch.utils.io import load_image

    print(f"mesh: {mesh.size()} x {device.type} ranks")
    pic = load_image(args.input)
    name = os.path.splitext(os.path.basename(args.input))[0] + "-sharded"
    deblur_module(
        pic, name, args.dest, args.blur_width,
        mask=args.mask, mask_size=args.mask_size,
        iterations=args.iterations,
        precision=args.precision, mesh=mesh, display=False, device=device,
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input")
    ap.add_argument("dest")
    ap.add_argument("--shard", type=int, default=0,
                    help="ranks to split the rows over (default: every GPU; one on the CPU)")
    ap.add_argument("--blur-width", type=int, default=9)
    ap.add_argument("--mask", type=int, nargs=2, default=None)
    ap.add_argument("--mask-size", type=int, default=255)
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--precision", default="exact", choices=["exact", "mixed", "fast"],
                    help="exact f32 is the recommended default; 'mixed' (bf16 convs) "
                         "needs the solver's DoF guard on long full-resolution solves")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ics_tpu_torch._device import resolve_device
    from ics_tpu_torch.parallel import TILE_AXIS
    from ics_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    device = resolve_device(args.device)
    if not args.shard:
        args.shard = torch.cuda.device_count() if device.type == "cuda" else 1
    _check_shard("shard_deblur", args.shard, device)
    _spawn(_deblur, args, device, TILE_AXIS)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
