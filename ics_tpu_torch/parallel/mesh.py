"""Device-mesh helpers (counterpart of ics_tpu/parallel/mesh.py).

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the initialized process group (``parallel.distributed.initialize``): one
process per rank, each on its own device, where the JAX package has one
controller over many devices.  Conventions used across the port:

* axis ``"tile"``: the rows of one large image, split across ranks, with
  halos exchanged between neighbours;
* axis ``"batch"``: independent images fanned out across ranks.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_mesh", "make_mesh_2d", "TILE_AXIS", "BATCH_AXIS", "axis_size"]

TILE_AXIS = "tile"
BATCH_AXIS = "batch"


def _device_type(device) -> str:
    kind = str(device).split(":")[0]
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return kind


def make_mesh(n_devices: int | None = None, axis_name: str = TILE_AXIS,
              device="cuda") -> DeviceMesh:
    """1-D mesh over the process group's ranks, one device each.

    ``n_devices`` must equal the group's size when given (every rank is in
    the mesh: a rank outside it would have no part in the collectives)."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"make_mesh({n_devices}) in a process group of {world} ranks: the "
            "mesh takes every rank"
        )
    return init_device_mesh(_device_type(device), (world,), mesh_dim_names=(axis_name,))


def make_mesh_2d(tile: int, batch: int, device="cuda") -> DeviceMesh:
    """(batch, tile) mesh: independent images over ``batch``, each image's
    rows over ``tile``; ``tile * batch`` must equal the group's size."""
    world = dist.get_world_size()
    if tile * batch != world:
        raise ValueError(
            f"make_mesh_2d(tile={tile}, batch={batch}) needs {tile * batch} ranks; "
            f"the process group has {world}"
        )
    return init_device_mesh(_device_type(device), (batch, tile),
                            mesh_dim_names=(BATCH_AXIS, TILE_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Number of ranks along ``axis`` (1 when the mesh has no such axis)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1
