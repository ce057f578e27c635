"""Command-line runner of the port (counterpart of ics_tpu/cli.py, with the
same subcommands, flags and defaults; ref deconvolve.py:370-423).

    python -m ics_tpu_torch deblur img/blured.tif out/ --blur-width 7 \\
        --mask 584 795 --tolerance 0.1 --iterations 200
    python -m ics_tpu_torch usm img/original.tif out/ --radius 5 --amount 1.5
    python -m ics_tpu_torch bilateral-lab img/DSC0001.tif out/ --radius 5
    python -m ics_tpu_torch tv-denoise img/DSC0001.tif out/ --weight 0.1

    python -m ics_tpu_torch deblur-batch 'burst/*.tif' out/ --psf psf.npz --shard 2

Everything runs on the GPU; ``main(argv, device="cpu")`` runs it on the CPU
(there is no flag for it).  ``--shard N`` starts N ranks, one process each
(``torch.multiprocessing``, spawned), joined over a free localhost port:
NCCL with a GPU each on CUDA (N up to the GPU count), gloo on the CPU (N up
to the core count).  Rank 0 writes the TIFFs and prints.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

def _check_shard(cmd: str, n: int, device) -> None:
    """``--shard N`` takes 1 to the GPU count on CUDA, 1 to the core count
    on the CPU."""
    available, what = ((torch.cuda.device_count(), "devices") if device.type == "cuda"
                       else (os.cpu_count() or 1, "CPU cores"))
    if n < 1 or n > available:
        raise SystemExit(
            f"{cmd}: --shard {n} must be between 1 and the {available} available {what}"
        )


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(run, args, device, axis: str) -> None:
    """Run ``run(args, device, mesh)`` on ``args.shard`` spawned ranks over a
    1-D mesh named ``axis``; raises if any rank fails."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(run, args, device.type, _free_port(), axis),
                       nprocs=args.shard, join=True, start_method="spawn")


def _rank_main(rank, run, args, device_type, port, axis) -> None:
    import contextlib

    import torch.distributed as dist

    from ics_tpu_torch.parallel import initialize, make_mesh

    if device_type == "cpu":  # the ranks share the cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.shard))
    initialize(f"127.0.0.1:{port}", args.shard, rank, device=device_type)
    try:
        mesh = make_mesh(args.shard, axis_name=axis, device=device_type)
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(
                null if rank else sys.stdout):
            run(args, torch.device(device_type), mesh)
    finally:
        dist.destroy_process_group()


def _cmd_deblur(args, device) -> int:
    if args.blur_width is None and args.psf is None:
        raise SystemExit("deblur: either --blur-width or --psf is required")
    if args.shard:
        from ics_tpu_torch.parallel import TILE_AXIS

        _check_shard("deblur", args.shard, device)
        _spawn(_deblur, args, device, TILE_AXIS)
        return 0
    return _deblur(args, device, None)


def _deblur(args, device, mesh) -> int:
    from ics_tpu_torch.models.pipeline import deblur_module
    from ics_tpu_torch.utils.io import load_image

    if args.profile == "fast":
        # one-flag speed profile; mirrors ics_tpu/cli.py:28-39, which also
        # overrides an explicit --early-stop 0 or --precision exact
        if args.blind_budget is None:
            args.blind_budget = 25
        if args.early_stop == 0.0:
            args.early_stop = 1e-3
        if args.precision == "exact":
            args.precision = "high"

    pic = load_image(args.input)
    name = os.path.splitext(os.path.basename(args.input))[0] + args.suffix
    deblur_module(
        pic,
        name,
        args.dest,
        args.blur_width if args.blur_width is not None else 3,
        confidence=args.confidence,
        tolerance=args.tolerance,
        quality=args.quality,
        bits=args.bits,
        mask=args.mask,
        display=False,
        blur=args.blur,
        preview=args.preview,
        mask_size=args.mask_size,
        iterations=args.iterations,
        solver=args.solver,
        psf_path=args.psf,
        save_psf_path=args.save_psf,
        precision=args.precision,
        early_stop=args.early_stop,
        blind_budget=args.blind_budget,
        use_tv=args.use_tv,
        tv_norm=args.tv_norm,
        inner_loop=args.inner_loop,
        trace=args.trace,
        nonblind_levels=args.nonblind_levels,
        mesh=mesh,
        device=device,
    )
    return 0


def _cmd_deblur_batch(args, device) -> int:
    """Batched non-blind deconvolution of a burst of same-shaped frames with
    one stored PSF: the reference README's PSF-reuse workflow (ref
    README.md:131-133), as ics_tpu/cli.py:87-171 runs it.  Estimate the PSF
    once (``deblur --save-psf``), then deconvolve the burst with per-frame
    whiteness stopping; ``--shard N`` splits the frames over N ranks."""
    import glob

    paths = sorted(glob.glob(args.pattern))
    if not paths:
        raise SystemExit(f"deblur-batch: no files match {args.pattern!r}")
    if args.shard:
        from ics_tpu_torch.parallel import BATCH_AXIS

        _check_shard("deblur-batch", args.shard, device)
        if len(paths) % args.shard:
            raise SystemExit(
                f"deblur-batch: batch of {len(paths)} frames must divide by "
                f"--shard {args.shard}"
            )
        _spawn(_deblur_batch, args, device, BATCH_AXIS)
        return 0
    return _deblur_batch(args, device, None)


def batch_inputs(pics: np.ndarray, psf: np.ndarray, bits: int | None, mask_size: int):
    """``deblur-batch``'s host preprocessing of a (B, H, W, 3) stack: scale by
    the bit depth (float input is taken as [0, 1]), remove gamma, pad each
    frame by the PSF's halo and centre the mask.  Returns (images, us, psfs,
    (top, bottom, left, right)) as float32 NumPy arrays, as ics_tpu's CLI
    makes them."""
    b, h, w, _ = pics.shape
    pad = psf.shape[0] // 2
    if np.issubdtype(pics.dtype, np.floating) and bits is None:
        imgs = pics.astype(np.float32) ** (1 / 2.2)
    else:
        bits = bits if bits is not None else (8 if pics.dtype == np.uint8 else 16)
        imgs = (pics.astype(np.float32) / float(2**bits - 1)) ** (1 / 2.2)
    mask_size = min(mask_size, min(h, w) - 2) | 1
    top = h // 2 - mask_size // 2
    left = w // 2 - mask_size // 2
    us = np.pad(imgs, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="edge")
    psfs = np.broadcast_to(psf, (b, *psf.shape))
    return imgs, us, psfs, (top, top + mask_size, left, left + mask_size)


def batch_codes(u_b: torch.Tensor) -> np.ndarray:
    """Deconvolved frames to 16-bit codes: clip, re-gamma, scale, truncate."""
    return (torch.clamp(u_b, 0.0, 1.0) ** 2.2 * (2**16 - 1)).to(torch.int32).cpu().numpy() \
        .astype(np.uint16)


def _deblur_batch(args, device, mesh) -> int:
    import glob

    import torch.distributed as dist

    from ics_tpu_torch.models.checkpoint import load_checkpoint
    from ics_tpu_torch.models.pipeline import QUALITY_STEP
    from ics_tpu_torch.parallel import batched_deconvolve
    from ics_tpu_torch.utils.io import imread_sequence, save

    psf = np.asarray(load_checkpoint(args.psf).psf, np.float32)
    paths = sorted(glob.glob(args.pattern))
    pics = np.asarray(imread_sequence(paths))
    if pics.ndim != 4 or pics.shape[-1] != 3:
        raise SystemExit(f"deblur-batch: expected a stack of RGB frames, got {pics.shape}")
    imgs, us, psfs, window = batch_inputs(pics, psf, args.bits, args.mask_size)
    u_b, _, stats_b = batched_deconvolve(
        imgs, us, psfs, *window, tau=args.tolerance / 100.0, iterations=args.iterations,
        step_factor=QUALITY_STEP[args.quality], lambd=args.confidence * 1000.0, blind=False,
        mesh=mesh, device=device,
    )
    out, stats = batch_codes(u_b), stats_b.cpu().numpy()
    if mesh is not None and dist.get_rank() != 0:
        return 0
    os.makedirs(args.dest, exist_ok=True)
    for i, path in enumerate(paths):
        name = os.path.splitext(os.path.basename(path))[0] + args.suffix
        save(out[i], name, args.dest)
        print(f"{name}: {int(stats[i][0])} outers, converged={bool(stats[i][1])}")
    return 0


def _load_unit(path: str, bits: int | None) -> np.ndarray:
    """Load an image scaled to [0, 1] by its bit depth (``2**bits - 1``, ref
    deconvolve.py:97); ``bits=None`` derives the depth from the dtype (uint8
    -> 8, uint16 -> 16; float input is taken as already in [0, 1])."""
    from ics_tpu_torch.utils.io import load_image

    pic = np.asarray(load_image(path))
    if bits is None:
        if pic.dtype == np.uint8:
            bits = 8
        elif pic.dtype == np.uint16:
            bits = 16
        elif np.issubdtype(pic.dtype, np.floating):
            return pic.astype(np.float32)
        else:
            raise SystemExit(
                f"cannot derive bit depth from dtype {pic.dtype}; pass --bits"
            )
    return pic.astype(np.float32) / float(2**bits - 1)


def _upload(path: str, bits: int | None, device) -> torch.Tensor:
    return torch.from_numpy(_load_unit(path, bits)).to(device)


def _save_16bit(out: torch.Tensor, input_path: str, suffix: str, dest: str) -> None:
    """Clip to [0, 1], scale to 16 bits and truncate, on the device; then
    save as ``<input stem><suffix>.tif``."""
    from ics_tpu_torch.utils.io import save

    codes = (torch.clamp(out, 0.0, 1.0) * (2**16 - 1)).to(torch.int32)
    name = os.path.splitext(os.path.basename(input_path))[0] + suffix
    os.makedirs(dest, exist_ok=True)
    save(codes.cpu().numpy(), name, dest)


def _per_channel(fn, pic: torch.Tensor) -> torch.Tensor:
    return torch.stack([fn(pic[..., c]) for c in range(pic.shape[-1])], dim=-1)


def _cmd_usm(args, device) -> int:
    from ics_tpu_torch.utils.filters import USM

    pic = _upload(args.input, args.bits, device)
    out = _per_channel(
        lambda p: USM(p, args.radius, args.strength, args.amount, method=args.method,
                      device=device),
        pic,
    )
    _save_16bit(out, args.input, "-usm", args.dest)
    return 0


def _cmd_bilateral(args, device) -> int:
    from ics_tpu_torch.utils.filters import bilateral_filter

    pic = _upload(args.input, args.bits, device)
    out = _per_channel(
        lambda p: bilateral_filter(p, args.radius, args.std_i, args.std_s, device=device),
        pic,
    )
    _save_16bit(out, args.input, "-bilateral", args.dest)
    return 0


def _cmd_bilateral_lab(args, device) -> int:
    from ics_tpu_torch.utils.filters import bilateral_lab

    pic = _upload(args.input, args.bits, device)
    out = bilateral_lab(pic, args.radius, args.std_i, args.std_s,
                        luminance_only=not args.all_channels, device=device)
    _save_16bit(out, args.input, "-bilateral-lab", args.dest)
    return 0


def _cmd_tv_denoise(args, device) -> int:
    from ics_tpu_torch.models.tv_denoise import tv_denoise

    pic = _upload(args.input, args.bits, device)
    out = tv_denoise(pic, weight=args.weight, iterations=args.iterations, device=device)
    _save_16bit(out, args.input, "-tv-denoise", args.dest)
    return 0


def main(argv=None, device="cuda") -> int:
    """Parse ``argv`` (``sys.argv[1:]`` when None) and run the subcommand on
    ``device``: 'cuda' (the default; raises without a GPU) or 'cpu'."""
    from ics_tpu_torch._device import resolve_device

    parser = argparse.ArgumentParser(prog="ics_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("deblur", help="blind/non-blind RL-TV deconvolution")
    p.add_argument("input")
    p.add_argument("dest")
    p.add_argument("--blur-width", type=int, default=None,
                   help="PSF size (required unless --psf is given)")
    p.add_argument("--psf", default=None, metavar="CKPT",
                   help="load a stored PSF checkpoint and skip the blind phase")
    p.add_argument("--save-psf", default=None, metavar="CKPT",
                   help="save the blind phase's estimated PSF checkpoint")
    p.add_argument("--confidence", type=float, default=10)
    p.add_argument("--tolerance", type=float, default=1)
    p.add_argument("--quality", default="normal",
                   choices=["low", "normal", "high", "veryhigh"])
    p.add_argument("--bits", type=int, default=8)
    p.add_argument("--mask", type=int, nargs=2, default=None)
    p.add_argument("--mask-size", type=int, default=255)
    p.add_argument("--blur", default="static", choices=["static", "motion"])
    p.add_argument("--preview", action="store_true")
    p.add_argument("--iterations", type=int, default=200)
    p.add_argument("--solver", default="mm", choices=["mm", "pam", "pd"],
                   help="mm=TV-MM (the reference's solver), pam=TV-PAM, "
                        "pd=TV-PD (Chambolle-Pock)")
    p.add_argument("--nonblind-levels", default="all", choices=["all", "final"],
                   help="run the non-blind pass at every pyramid scale "
                        "(reference parity) or only at full resolution")
    p.add_argument("--precision", default="exact",
                   choices=["exact", "high", "mixed", "fast", "hybrid",
                            "hybrid-high"],
                   help="exact=f32 reference parity; high=f32 with split-bf16 "
                        "tensor-core convs of 81+ taps; mixed=bf16 convs + f32 "
                        "residual; fast=all-bf16; hybrid / hybrid-high=mixed / "
                        "high on the coarse non-blind levels of 2 MP or more")
    p.add_argument("--trace", action="store_true",
                   help="print a per-stage wall-clock profile at the end "
                        "(stage boundaries synchronize the device)")
    p.add_argument("--use-tv", action="store_true",
                   help="enable the TV regularization ('mm' solver)")
    p.add_argument("--tv-norm", default="channel",
                   choices=["channel", "collab", "collab_l2"],
                   help="TV channel coupling with --use-tv")
    p.add_argument("--inner-loop", default="auto",
                   choices=["auto", "xla", "pallas", "pallas_unrolled"],
                   help="xla=the op-level inner loop; pallas / pallas_unrolled="
                        "the one-launch inner-loop kernel where it takes the "
                        "window and mode; auto=the kernel on the GPU where it "
                        "takes them")
    p.add_argument("--early-stop", type=float, default=0.0, metavar="R",
                   help="stop a NON-BLIND pyramid level once the whiteness "
                        "metric stops improving by cumulative relative R over "
                        "10 consecutive outers (0 = off, reference parity)")
    p.add_argument("--blind-budget", type=int, default=None, metavar="N",
                   help="cap the COARSE blind pyramid levels at N outer "
                        "iterations (off by default: reference parity)")
    p.add_argument("--shard", type=int, default=0, metavar="N",
                   help="split the full-frame non-blind solves' rows over N "
                        "ranks (GPUs; CPU processes with the CPU)")
    p.add_argument("--profile", default="quality", choices=["quality", "fast"],
                   help="'fast' = --blind-budget 25 + --early-stop 1e-3 + "
                        "--precision high")
    p.add_argument("--suffix", default="-deblurred")
    p.set_defaults(fn=_cmd_deblur)

    def _bits_arg(sp):
        sp.add_argument(
            "--bits", type=int, default=None,
            help="input bit depth for the [0,1] normalization (ref "
                 "deconvolve.py:97); default derives it from the file dtype "
                 "(uint8 -> 8, uint16 -> 16)")

    p = sub.add_parser("deblur-batch",
                       help="batched non-blind deconvolution of a burst with one "
                            "stored PSF")
    p.add_argument("pattern", help="glob of same-shaped frames (quote it)")
    p.add_argument("dest")
    p.add_argument("--psf", required=True, metavar="CKPT",
                   help="PSF checkpoint from 'deblur --save-psf'")
    p.add_argument("--confidence", type=float, default=10)
    p.add_argument("--tolerance", type=float, default=1)
    p.add_argument("--quality", default="normal",
                   choices=["low", "normal", "high", "veryhigh"])
    p.add_argument("--mask-size", type=int, default=255)
    p.add_argument("--iterations", type=int, default=200)
    p.add_argument("--shard", type=int, default=0, metavar="N",
                   help="split the frames over N ranks (GPUs; CPU processes "
                        "with the CPU)")
    p.add_argument("--suffix", default="-deblurred")
    _bits_arg(p)
    p.set_defaults(fn=_cmd_deblur_batch)

    p = sub.add_parser("usm", help="unsharp mask")
    p.add_argument("input")
    p.add_argument("dest")
    p.add_argument("--radius", type=int, default=5)
    p.add_argument("--strength", type=float, default=8.0)
    p.add_argument("--amount", type=float, default=1.0)
    p.add_argument("--method", default="bessel", choices=["bessel", "gauss"])
    _bits_arg(p)
    p.set_defaults(fn=_cmd_usm)

    p = sub.add_parser("bilateral", help="bilateral denoise (RGB channels)")
    p.add_argument("input")
    p.add_argument("dest")
    p.add_argument("--radius", type=int, default=5)
    p.add_argument("--std-i", type=float, default=0.1)
    p.add_argument("--std-s", type=float, default=5.0)
    _bits_arg(p)
    p.set_defaults(fn=_cmd_bilateral)

    p = sub.add_parser("bilateral-lab", help="bilateral denoise in CIELAB")
    p.add_argument("input")
    p.add_argument("dest")
    p.add_argument("--radius", type=int, default=5)
    p.add_argument("--std-i", type=float, default=5.0)
    p.add_argument("--std-s", type=float, default=5.0)
    p.add_argument("--all-channels", action="store_true")
    _bits_arg(p)
    p.set_defaults(fn=_cmd_bilateral_lab)

    p = sub.add_parser("tv-denoise", help="Chambolle TV denoise")
    p.add_argument("input")
    p.add_argument("dest")
    p.add_argument("--weight", type=float, default=0.1)
    p.add_argument("--iterations", type=int, default=50)
    _bits_arg(p)
    p.set_defaults(fn=_cmd_tv_denoise)

    args = parser.parse_args(argv)
    return args.fn(args, resolve_device(device))


if __name__ == "__main__":
    sys.exit(main())
