"""One rank of the port's multi-process cases (tests/test_torch_distributed.py).

    python tests/_torch_parallel_worker.py DIR PORT RANK WORLD

Joins a gloo group of WORLD CPU processes over localhost:PORT, reads the
inputs the test wrote to DIR (``in_*.npy``), runs every case of its world
size and writes each case's arrays to ``DIR/<case>_r<RANK>.npz``; an
expected error is saved as its message.  Imports torch and the port only.
"""

import contextlib
import io
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from ics_tpu_torch import deblur_module
from ics_tpu_torch.models.rl_mm import RLConfig, richardson_lucy_MM
from ics_tpu_torch.parallel import (
    BATCH_AXIS,
    batched_deconvolve,
    initialize,
    local_batch_slice,
    make_mesh,
    make_mesh_2d,
    sharded_convolve_rgb,
    sharded_richardson_lucy,
)
from ics_tpu_torch.parallel.tiling import gather_rows, row_counts

DIR, PORT, RANK, WORLD = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])


def load(name):
    return np.load(os.path.join(DIR, f"in_{name}.npy"))


def box(m, pad):
    return pad + 1, m - pad - 1, pad + 1, m - pad - 1


def centred(m, size):
    """A size x size mask centred in an m x m image, as deblur-batch puts it:
    on 4 ranks the first rank's rows lie wholly above it."""
    top = m // 2 - size // 2
    return top, top + size, top, top + size


def result(res):
    return dict(u=res.u.numpy(), psf=res.psf.numpy(), stats=res.stats.numpy(),
                u_full=res.u_full.numpy(), image=res.image.numpy())


def error(fn):
    """The message of the ValueError ``fn`` raises ('' if none)."""
    try:
        fn()
    except ValueError as exc:
        return np.array(str(exc))
    return np.array("")


def case_convolve(mesh):
    img, kern = load("conv_image"), load("conv_kernel")
    block = sharded_convolve_rgb(img, kern, mesh)
    group = mesh.get_group("tile")
    whole = gather_rows(block, row_counts(img.shape[0], WORLD), group, dim=0)
    return dict(block=block.numpy(), whole=whole.numpy())


def case_sharded(mesh):
    image, u, psf = load("smooth_image"), load("smooth_u"), load("smooth_psf")
    m, pad = image.shape[0], (u.shape[0] - image.shape[0]) // 2
    kw = dict(iterations=3, step_factor=1e-3, lambd=1000.0, blind=True,
              config=RLConfig(record_metrics=True))
    first = sharded_richardson_lucy(image, u, psf, *box(m, pad), 0.0, mesh=mesh, **kw)
    again = sharded_richardson_lucy(image, u, psf, *box(m, pad), 0.0, mesh=mesh, **kw)
    single = richardson_lucy_MM(image, u, psf, *box(m, pad), 0.0, device="cpu", **kw)
    out = {k: v for k, v in result(first).items()}
    out.update({f"again_{k}": v for k, v in result(again).items()})
    out.update({f"single_{k}": v for k, v in result(single).items()})
    out.update({f"traj_{k}": v for k, v in first.trajectory.items()})
    out.update({f"single_traj_{k}": v for k, v in single.trajectory.items()})
    return out


def case_window(mesh):
    """The blind solve of case_sharded with a centred mask window."""
    image, u, psf = load("smooth_image"), load("smooth_u"), load("smooth_psf")
    kw = dict(iterations=3, step_factor=1e-3, lambd=1000.0, blind=True,
              config=RLConfig(record_metrics=True))
    sharded = sharded_richardson_lucy(image, u, psf, *centred(63, 21), 0.0, mesh=mesh, **kw)
    single = richardson_lucy_MM(image, u, psf, *centred(63, 21), 0.0, device="cpu", **kw)
    out = dict(result(sharded))
    out.update({f"single_{k}": v for k, v in result(single).items()})
    out.update({f"traj_{k}": v for k, v in sharded.trajectory.items()})
    return out


# the modes whose halos and reductions differ: TV stencils, the mixed
# residual's increments, the split convolution, motion blur's mean PSF
MODES = {
    "tv_collab": (False, dict(use_tv=True, tv_norm="collab")),
    "mixed": (False, dict(dtype="mixed")),
    "high": (False, dict(conv_precision="high", dof_guard=True)),
    "motion": (True, dict()),
}


def case_modes(mesh):
    image, u, psf = load("smooth_image"), load("smooth_u"), load("smooth_psf")
    m, pad = image.shape[0], (u.shape[0] - image.shape[0]) // 2
    out = {}
    for name, (blind, cfg) in MODES.items():
        kw = dict(iterations=4, step_factor=1e-3, lambd=1000.0, blind=blind,
                  correlation=name == "motion", config=RLConfig(**cfg))
        sh = sharded_richardson_lucy(image, u, psf, *box(m, pad), 0.01, mesh=mesh, **kw)
        single = richardson_lucy_MM(image, u, psf, *box(m, pad), 0.01, device="cpu", **kw)
        out[f"{name}_u"], out[f"{name}_single_u"] = sh.u.numpy(), single.u.numpy()
        out[f"{name}_psf"], out[f"{name}_single_psf"] = sh.psf.numpy(), single.psf.numpy()
        out[f"{name}_stats"], out[f"{name}_single_stats"] = sh.stats.numpy(), single.stats.numpy()
    return out


def case_batch_2d(mesh):
    images, us, psfs = load("b2d_images"), load("b2d_us"), load("b2d_psfs")
    m, pad = images.shape[1], (us.shape[1] - images.shape[1]) // 2
    mesh2 = make_mesh_2d(tile=2, batch=2, device="cpu")
    u_b, psf_b, stats_b = batched_deconvolve(images, us, psfs, *box(m, pad), iterations=2,
                                             blind=True, mesh=mesh2)
    return dict(u=u_b.numpy(), psf=psf_b.numpy(), stats=stats_b.numpy())


def case_tile4(mesh):
    """A (batch 1, tile 4) mesh with a centred mask, against one device."""
    images, us, psfs = load("b2d_images"), load("b2d_us"), load("b2d_psfs")
    kw = dict(iterations=2, blind=True, schedule="vmap")
    tiled = batched_deconvolve(images, us, psfs, *centred(16, 7),
                               mesh=make_mesh_2d(tile=4, batch=1, device="cpu"), **kw)
    single = batched_deconvolve(images, us, psfs, *centred(16, 7), device="cpu", **kw)
    return {**{k: t.numpy() for k, t in zip(("u", "psf", "stats"), tiled)},
            **{f"single_{k}": t.numpy() for k, t in zip(("u", "psf", "stats"), single)}}


def case_stopping(mesh):
    """The per-lane stopping fixture over a batch mesh of every rank:
    'shard_map' (each rank its lanes) and 'vmap' (each rank folds its lanes)."""
    images, us, psfs = load("stop_images"), load("stop_us"), load("stop_psfs")
    m, pad = images.shape[1], (us.shape[1] - images.shape[1]) // 2
    bmesh = make_mesh(WORLD, axis_name=BATCH_AXIS, device="cpu")
    out = {}
    for schedule in ("shard_map", "vmap"):
        u_b, psf_b, stats_b = batched_deconvolve(
            images, us, psfs, *box(m, pad), iterations=25, step_factor=1e-3, lambd=1000.0,
            blind=True, use_stopping=True, schedule=schedule, mesh=bmesh)
        out.update({f"{schedule}_u": u_b.numpy(), f"{schedule}_psf": psf_b.numpy(),
                    f"{schedule}_stats": stats_b.numpy()})
    return out


def case_validations(mesh):
    images, us, psfs = load("stop_images")[:3], load("stop_us")[:3], load("stop_psfs")[:3]
    m, pad = images.shape[1], (us.shape[1] - images.shape[1]) // 2
    args = (images, us, psfs, *box(m, pad))
    return dict(
        whole=error(lambda: batched_deconvolve(*args, schedule="shard_map",
                                               mesh=make_mesh_2d(tile=2, batch=2, device="cpu"))),
        divide=error(lambda: batched_deconvolve(
            *args, schedule="shard_map", mesh=make_mesh(WORLD, axis_name=BATCH_AXIS,
                                                        device="cpu"))),
        slice8=np.array([local_batch_slice(8).start, local_batch_slice(8).stop]),
        slice6=error(lambda: local_batch_slice(6)),
        pam=error(lambda: deblur_module(
            np.zeros((32, 32, 3), np.uint8), "t", None, blur_width=3, mask=[16, 16],
            mask_size=7, solver="pam", mesh=mesh, verbose=False, device="cpu")),
    )


def case_pipeline(mesh):
    pic = load("pipe_pic")
    stats = []
    kw = dict(blur_width=5, mask=[30, 32], mask_size=31, tolerance=0.1, iterations=3,
              verbose=False, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        sharded = deblur_module(pic, "t", None, mesh=mesh, stats_out=stats, **kw)
        single = deblur_module(pic, "t", None, **kw)
    blind = [s["result"].psf.numpy() for s in stats if s["case"] == "blind"]
    return dict(sharded=sharded, single=single, **{f"blind_psf{i}": p for i, p in enumerate(blind)})


CASES = {
    4: (case_convolve, case_sharded, case_window, case_modes, case_batch_2d, case_tile4,
        case_stopping,
        case_validations, case_pipeline),
    2: (case_stopping,),
}


def main():
    torch.set_num_threads(1)
    initialize(f"127.0.0.1:{PORT}", WORLD, RANK, device="cpu")
    try:
        mesh = make_mesh(WORLD, device="cpu")
        for case in CASES[WORLD]:
            out = case(mesh)
            np.savez(os.path.join(DIR, f"{case.__name__[5:]}_r{RANK}.npz"), **out)
    finally:
        dist.destroy_process_group()
    print(f"RANK{RANK}-OK")


if __name__ == "__main__":
    main()
