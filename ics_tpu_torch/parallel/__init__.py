"""Many images and many GPUs: mesh helpers, row tiling with halo exchange,
batched deconvolution across images, and joining a multi-process group
(counterpart of ics_tpu/parallel/__init__.py)."""

from ics_tpu_torch.parallel.mesh import BATCH_AXIS, TILE_AXIS, make_mesh, make_mesh_2d
from ics_tpu_torch.parallel.tiling import sharded_richardson_lucy, sharded_convolve_rgb
from ics_tpu_torch.parallel.batch import batched_deconvolve
from ics_tpu_torch.parallel.distributed import initialize, local_batch_slice

__all__ = [
    "BATCH_AXIS",
    "TILE_AXIS",
    "make_mesh",
    "make_mesh_2d",
    "sharded_richardson_lucy",
    "sharded_convolve_rgb",
    "batched_deconvolve",
    "initialize",
    "local_batch_slice",
]
