"""Batched deconvolution of independent images (counterpart of
ics_tpu/parallel/batch.py).

Every image ("lane") stops on its own residual-whiteness test, as an
independent solve would (ref lib/deconvolution.pyx:643-654 per image).
Schedules:

* ``'map'``: lanes one after another through the single-image solver, so
  each takes its usual kernels (K2 where the window fits, K3, K1) and an
  early stop saves real work.  No mesh.
* ``'vmap'``: one solve over the whole batch.  The lanes fold into the
  planar channel axis, (3B, H, W), so every convolution is one K1 launch
  for all lanes; the maxima, the blind PSF step and the stop test stay per
  lane, and a lane that stops drops out of the fold with its state kept.
  As in the JAX package, the PSF gradient takes the convolution path and
  the inner loop the op loop.  Under a 1-D ``batch`` mesh each rank folds
  its own lanes; under a mesh with a ``tile`` axis (``make_mesh_2d``) each
  batch group folds its lanes and shards their rows over its tile ranks
  (``parallel.tiling``).
* ``'shard_map'``: lanes split over a 1-D ``batch`` mesh, each rank running
  its lanes as ``'map'`` does.
* ``'auto'``: ``'map'`` without a mesh; ``'shard_map'`` on a batch-only
  mesh; ``'vmap'`` otherwise.

Every rank passes the whole batch and gets the whole result back.
"""

from __future__ import annotations

import torch

from ics_tpu_torch._device import resolve_device, to_f32
from ics_tpu_torch.models.rl_mm import RLConfig, _solve
from ics_tpu_torch.ops.reductions import whiteness_weights
from ics_tpu_torch.parallel.mesh import TILE_AXIS, axis_size
from ics_tpu_torch.parallel.tiling import RowShard, gather_rows, solve_rows

__all__ = ["batched_deconvolve"]


def batched_deconvolve(
    images,
    us,
    psfs,
    top: int,
    bottom: int,
    left: int,
    right: int,
    *,
    iterations: int = 50,
    step_factor: float = 1e-3,
    lambd: float = 10000.0,
    blind: bool = True,
    correlation: bool = False,
    tau: float = 0.0,
    use_stopping: bool = True,
    config: RLConfig | None = None,
    mesh=None,
    batch_axis: str = "batch",
    schedule: str = "auto",
    device="cuda",
):
    """Deconvolve a batch: images (B,M,N,3), us (B,uM,uN,3), psfs (B,MK,MK,3).

    Returns (u_batch, psf_batch, stats_batch) as tensors on the rank's
    device; ``stats_batch[b]`` is lane b's [iterations, converged, M_r, Hu,
    varu].  ``device`` is used without a mesh; under one, the mesh's device
    type (the rank's own device) is.
    """
    cfg = config or RLConfig()
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    batch_only_mesh = (
        mesh is not None and batch_axis in names and axis_size(mesh, batch_axis) == mesh.size()
    )
    if schedule == "auto":
        if mesh is None:
            schedule = "map"
        else:
            schedule = "shard_map" if batch_only_mesh else "vmap"
    if schedule not in ("vmap", "map", "shard_map"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "map" and mesh is not None:
        raise ValueError(
            "schedule='map' serializes lanes and cannot shard over a mesh; "
            "use 'shard_map' or 'vmap' (the 'auto' defaults under a mesh)"
        )
    if schedule == "shard_map":
        if mesh is None:
            raise ValueError("schedule='shard_map' requires a mesh")
        if not batch_only_mesh:
            raise ValueError(
                "schedule='shard_map' keeps each image whole on one device "
                "— every non-batch mesh axis must have size 1 (got "
                f"{dict(zip(names, mesh.shape))}); use 'vmap' for (batch, tile) meshes"
            )
    groups = axis_size(mesh, batch_axis) if mesh is not None else 1
    b = len(images)
    if b % groups:
        raise ValueError(
            f"batch {b} must divide by the mesh's {batch_axis} axis ({groups})"
        )
    dev = torch.device(mesh.device_type) if mesh is not None else resolve_device(device)
    batched = schedule == "vmap"
    solve_kwargs = dict(
        top=int(top), bottom=int(bottom), left=int(left), right=int(right),
        tau=float(tau), step_factor=float(step_factor), lambd=float(lambd),
        iterations=int(iterations), blind=bool(blind), correlation=bool(correlation),
        use_tv=cfg.use_tv, tv_method=cfg.tv_method, tv_norm=cfg.tv_norm,
        conv_method=cfg.conv_method, conv_precision=cfg.conv_precision,
        dtype=cfg.dtype, dof_guard=cfg.dof_guard, early_stop=cfg.early_stop,
        early_stop_patience=cfg.early_stop_patience,
        # one batched program takes the portable paths, as under JAX's vmap
        psf_grad="conv" if batched else cfg.psf_grad,
        inner_loop="xla" if batched else cfg.inner_loop,
        use_stopping=bool(use_stopping),
    )
    weights = whiteness_weights(bottom - top, right - left)

    # the lanes of this rank's batch group, sliced before they are uploaded
    # (and, under a tile axis, only this rank's rows of them)
    group_rank = mesh.get_local_rank(batch_axis) if groups > 1 else 0
    per = b // groups
    mine = slice(group_rank * per, (group_rank + 1) * per)
    lanes = (images[mine], us[mine], psfs[mine])
    upload = lambda *xs: [to_f32(x, dev) for x in xs]
    if batched:
        tile = axis_size(mesh, TILE_AXIS) if mesh is not None else 1
        if tile > 1:
            shard = RowShard(mesh.get_group(TILE_AXIS), us.shape[1], images.shape[1])
            u_b, _, psf_b, _, stats_b, _ = solve_rows(*lanes, weights, shard, dev,
                                                      **solve_kwargs)
        else:
            u_b, _, psf_b, _, stats_b, _ = _solve(*upload(*lanes), weights, **solve_kwargs)
    else:  # one lane on the device at a time
        outs = [_solve(*upload(im, u, p), weights, **solve_kwargs)[0:5:2]  # u, psf, stats
                for im, u, p in zip(*lanes)]
        u_b, psf_b, stats_b = (torch.stack(t) for t in zip(*outs))
    if groups > 1:
        group = mesh.get_group(batch_axis)
        u_b, psf_b, stats_b = (gather_rows(t, [per] * groups, group, dim=0)
                               for t in (u_b, psf_b, stats_b))
    return u_b, psf_b, stats_b
