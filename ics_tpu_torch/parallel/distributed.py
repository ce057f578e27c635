"""Joining the process group, and the batch fan-out across processes
(counterpart of ics_tpu/parallel/distributed.py).

JAX runs one controller over every device; here each rank is a process with
one device.  ``initialize`` wraps ``torch.distributed.init_process_group``
and makes the rank's GPU the current device, so that ``device='cuda'``
names it; after it, ``make_mesh`` and the sharded solvers span every rank,
and ``local_batch_slice`` says which images a rank loads.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["initialize", "local_batch_slice"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None, device="cuda") -> None:
    """Join the process group.

    With no arguments it reads torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``); otherwise
    it takes ``"host:port"``, the process count and this process's id, as
    the JAX wrapper does.  ``backend=None`` picks NCCL for ``device='cuda'``
    when every rank on the host has a GPU of its own, and gloo for
    ``device='cpu'``.  More CUDA ranks on a host than GPUs raises unless
    ``backend='gloo'`` is passed: NCCL refuses two ranks on one GPU, and
    two ranks sharing a card over gloo is a layout to ask for, not a
    fallback.
    """
    kind = torch.device(device).type
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit) and any(v is None for v in explicit):
        raise ValueError(
            "pass coordinator_address, num_processes and process_id together, "
            "or none of them (torchrun's environment)"
        )
    if coordinator_address is None:
        init_method, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        init_method, world, rank = f"tcp://{coordinator_address}", num_processes, process_id
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if kind == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: use 'gloo'")
        backend = "gloo"
    elif kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU"
            )
        gpus = torch.cuda.device_count()
        if backend is None:
            if local_world > gpus:
                raise ValueError(
                    f"{local_world} CUDA ranks on a host with {gpus} GPUs: NCCL needs "
                    "a GPU per rank; pass backend='gloo' to share a GPU"
                )
            backend = "nccl"
        elif backend not in ("nccl", "gloo"):
            raise ValueError(f"unknown backend {backend!r} (use 'nccl' or 'gloo')")
        # this rank's device: cuda:{local_rank % device_count}
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % gpus)
    else:
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


def local_batch_slice(batch_size: int) -> slice:
    """The slice of a batch this rank loads: with B images over P ranks,
    rank p loads images [p*B/P, (p+1)*B/P)."""
    p = dist.get_rank()
    n = dist.get_world_size()
    per = batch_size // n
    if batch_size % n:
        raise ValueError(
            f"batch size {batch_size} must be divisible by process count {n}"
        )
    return slice(p * per, (p + 1) * per)
