"""Row tiling of large images across ranks, with halo exchange
(counterpart of ics_tpu/parallel/tiling.py).

The JAX package lets GSPMD partition its solver; here each rank owns a
block of rows and the solver's op loop (``ops/cuda_solver.py::
inner_loop_ops``, on the usual conv dispatch: K1, K4s, K4; K3; K5) runs
on the block, told by a ``RowShard`` where it needs its neighbours' rows
and which reductions span every rank.  The communication helpers:

* ``halo_exchange``: the rows a stencil needs from the ranks above and
  below;
* ``all_reduce_max`` and ``all_reduce_sum`` (the sum gathers the ranks'
  parts and adds them in rank order, so every rank gets the same bits on
  every run);
* ``gather_rows``: row blocks of any sizes, joined in rank order on every
  rank.

On a gloo group CUDA tensors travel through pinned host memory (gloo has no
send or receive of device memory); on NCCL they stay on the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ics_tpu_torch._device import exact_f32, to_f32
from ics_tpu_torch.models.rl_mm import RLConfig, RLResult, _solve, print_solver_report
from ics_tpu_torch.ops.conv import conv_planar
from ics_tpu_torch.ops.reductions import whiteness_weights

__all__ = [
    "sharded_convolve_rgb", "sharded_richardson_lucy", "halo_exchange", "all_reduce_max",
    "all_reduce_sum", "gather_rows", "row_counts", "RowShard",
]


def row_counts(rows: int, ranks: int) -> list[int]:
    """Rows per rank of an even split, the first ``rows % ranks`` ranks one
    row more."""
    return [rows // ranks + (r < rows % ranks) for r in range(ranks)]


def _staged(t: torch.Tensor, group) -> bool:
    """True where ``t`` must travel through host memory: a CUDA tensor on a
    gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor, staged: bool) -> torch.Tensor:
    """``t`` contiguous, copied to pinned host memory when ``staged``."""
    t = t.contiguous()
    if not staged:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes: every dtype travels alike."""
    return t.reshape(-1).view(torch.uint8)


def _rows(x, lo: int, hi: int, dim: int):
    """Rows [lo, hi) along ``dim`` of a NumPy array or a tensor, as a view:
    a rank slices its share before it uploads it."""
    index = [slice(None)] * x.ndim
    index[dim] = slice(lo, hi)
    return x[tuple(index)]


def _peer(group, rank: int) -> int:
    return dist.get_global_rank(group or dist.group.WORLD, rank)


def halo_exchange(block: torch.Tensor, rows_above: int, rows_below: int, group=None,
                  dim: int = -2) -> torch.Tensor:
    """``block`` with ``rows_above`` rows of the rank above on top and
    ``rows_below`` rows of the rank below underneath, joined along ``dim``;
    the first rank gets nothing above and the last nothing below.  Every
    rank of ``group`` calls it with the same counts."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    n = block.shape[dim]
    if (rank > 0 and rows_below > n) or (rank < size - 1 and rows_above > n):
        raise ValueError(
            f"a halo of {rows_above}/{rows_below} rows from a block of {n} rows"
        )
    staged = _staged(block, group)
    ops, got = [], []
    # (neighbour, the rows it gets from this block, the rows it sends here)
    for peer, (start, count), recv in ((rank - 1, (0, rows_below), rows_above),
                                       (rank + 1, (n - rows_above, rows_above), rows_below)):
        if not 0 <= peer < size:
            got.append(None)
            continue
        if count:
            ops.append(dist.P2POp(dist.isend, _bytes(_host(block.narrow(dim, start, count),
                                                            staged)), _peer(group, peer), group))
        shape = list(block.shape)
        shape[dim] = recv
        buf = torch.empty(shape, dtype=block.dtype, pin_memory=staged,
                          device="cpu" if staged else block.device)
        if recv:
            ops.append(dist.P2POp(dist.irecv, _bytes(buf), _peer(group, peer), group))
        got.append(buf)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    above, below = (b.to(block.device, non_blocking=True) if b is not None and b.numel()
                    else None for b in got)
    parts = [p for p in (above, block, below) if p is not None]
    return torch.cat(parts, dim=dim) if len(parts) > 1 else block


def _all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (all of one shape and dtype), in rank order."""
    wire = _bytes(_host(t, _staged(t, group)))
    outs = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, wire, group=group)
    return [o.view(t.dtype).reshape(t.shape).to(t.device, non_blocking=True) for o in outs]


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of every rank's ``t`` (computed in float32,
    which holds every float16/bfloat16 value exactly)."""
    x = t.to(torch.float32, copy=True)
    if _staged(x, group):
        host = x.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.MAX, group=group)
        x = host.to(t.device)
    else:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x.to(t.dtype)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``t``, added in rank order on every rank: the
    same bits on every rank and on every run."""
    parts = _all_gather(t, group)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def gather_rows(block: torch.Tensor, counts: list[int], group=None,
                dim: int = -2) -> torch.Tensor:
    """Every rank's row block joined along ``dim`` in rank order; rank r's
    block has ``counts[r]`` rows (``all_gather`` needs one size, so each is
    padded to the largest and trimmed after)."""
    rank = dist.get_rank(group)
    x = block.movedim(dim, 0)
    if x.shape[0] != counts[rank]:
        raise ValueError(f"rank {rank} holds {x.shape[0]} rows, counts say {counts[rank]}")
    big = max(counts)
    if big == 0:
        return block.narrow(dim, 0, 0)
    padded = torch.zeros((big, *x.shape[1:]), dtype=x.dtype, device=x.device)
    padded[: x.shape[0]] = x
    parts = _all_gather(padded, group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).movedim(0, dim)


class RowShard:
    """This rank's share of a row-sharded solve over ``group``.

    The padded iterate u has ``u_rows`` rows and the observed image ``rows``
    (image row i sits at u row i + pad).  The u rows split evenly over the
    ranks; a rank owns the image rows under its u rows.  The solver runs on
    the owned rows; ``extend`` adds the pad = mk//2 rows a 'valid'
    convolution or a stencil reads from each neighbour, ``own`` cuts an
    extended result back to the owned rows.
    """

    def __init__(self, group, u_rows: int, rows: int):
        self.group = group
        self.rank, self.size = dist.get_rank(group), dist.get_world_size(group)
        self.u_rows, self.rows = u_rows, rows
        pad = self.pad = (u_rows - rows) // 2
        starts = np.cumsum([0] + row_counts(u_rows, self.size)).tolist()
        self.u_bounds = list(zip(starts[:-1], starts[1:]))
        self.image_bounds = [(max(a - pad, 0), min(b - pad, rows)) for a, b in self.u_bounds]
        if any(b - a < max(2 * pad, 1) for a, b in self.u_bounds):
            raise ValueError(
                f"{u_rows} rows over {self.size} ranks leave a block under the "
                f"{2 * pad} rows a halo exchange of {pad} rows needs"
            )
        self.a, self.b = self.u_bounds[self.rank]
        self.ia, self.ib = self.image_bounds[self.rank]
        # the owned u rows that hold image rows (the solver's inner crop)
        self.crop = slice(self.ia + pad - self.a, self.ib + pad - self.a)
        self.above = pad if self.rank > 0 else 0  # halo rows above an extended block

    def block(self, x, space: str, dim: int = -2):
        """This rank's rows of a whole u-space or image-space array (a NumPy
        array or a tensor), as a view."""
        lo, hi = (self.a, self.b) if space == "u" else (self.ia, self.ib)
        return _rows(x, lo, hi, dim)

    def extend(self, x: torch.Tensor) -> torch.Tensor:
        """Owned rows plus ``pad`` rows from each neighbour (planar)."""
        return halo_exchange(x, self.pad, self.pad, self.group)

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """The owned u rows of an ``extend``-ed u-space array's result."""
        return x.narrow(-2, self.above, self.b - self.a)

    def full(self, conv, e: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """``conv(error, k, 'full')`` on the owned u rows: the image-space
        ``e`` extended by ``pad`` rows each side, then the rows of the
        extended block's 'full' result that this rank owns."""
        out = conv(self.extend(e), k, "full")
        return out.narrow(-2, self.a - (self.ia - self.above), self.b - self.a)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_max(t, self.group)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(t, self.group)

    def gather(self, x: torch.Tensor, lo: int, hi: int, space: str) -> torch.Tensor:
        """Rows [lo, hi) of a u-space or image-space array (planar), whole
        on every rank."""
        bounds = self.u_bounds if space == "u" else self.image_bounds
        spans = [(max(lo, a), min(hi, b)) for a, b in bounds]
        counts = [max(e - s, 0) for s, e in spans]
        # a rank whose rows lie wholly above or below the window sends none
        start = spans[self.rank][0] - bounds[self.rank][0] if counts[self.rank] else 0
        return gather_rows(x.narrow(-2, start, counts[self.rank]), counts, self.group)

    def gather_all(self, x: torch.Tensor, space: str, dim: int = -2) -> torch.Tensor:
        """A whole array from every rank's block of it."""
        bounds = self.u_bounds if space == "u" else self.image_bounds
        return gather_rows(x, [b - a for a, b in bounds], self.group, dim)


def _mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on: the current CUDA device
    (``initialize`` pins it) or the CPU."""
    return torch.device(mesh.device_type)


def sharded_convolve_rgb(image, kernel, mesh, axis: str = "tile") -> torch.Tensor:
    """'same' per-channel convolution (zero boundary) of an (H, W, 3) image
    sharded by rows over ``mesh``'s ``axis``.

    Each rank takes its row block (``row_counts(H, ranks)``), receives
    mk//2 rows from each neighbour (zeros at the image's top and bottom
    edges), and convolves block plus halo 'valid' (K1 on CUDA tensors).
    Returns this rank's (rows, W, 3) block; ``gather_rows(out,
    row_counts(H, ranks), group, dim=0)`` joins the image.
    """
    exact_f32()
    dev = _mesh_device(mesh)
    kernel = to_f32(kernel, dev)
    mk = kernel.shape[0]
    if mk % 2 == 0:
        raise ValueError("sharded convolution requires an odd kernel")
    h = mk // 2
    group = mesh.get_group(axis)
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    counts = row_counts(image.shape[0], size)
    start = sum(counts[:rank])
    blk = to_f32(_rows(image, start, start + counts[rank], 0), dev).permute(2, 0, 1).contiguous()
    ext = halo_exchange(blk, h, h, group)
    # zero rows at the image's own edges, zero columns at both sides
    ext = F.pad(ext, (h, h, h if rank == 0 else 0, h if rank == size - 1 else 0))
    k = kernel.permute(2, 0, 1).contiguous() if kernel.ndim == 3 else \
        kernel.unsqueeze(0).expand(3, mk, mk).contiguous()
    return conv_planar(ext, k, "valid").permute(1, 2, 0).contiguous()


def solve_rows(image, u, psf, weights, shard: RowShard, device, **solve_kwargs):
    """``_solve`` with the rows of (..., H, W, 3) ``image`` and ``u`` split
    by ``shard``: each rank uploads its block to ``device`` and solves it,
    then every rank gathers the whole result.  Returns what ``_solve``
    returns."""
    u_out, u_full, psf, image_out, stats, hist = _solve(
        to_f32(shard.block(image, "image", -3), device), to_f32(shard.block(u, "u", -3), device),
        to_f32(psf, device), weights, shard=shard, **solve_kwargs
    )
    return (shard.gather_all(u_out, "image", -3), shard.gather_all(u_full, "u", -3), psf,
            shard.gather_all(image_out, "image", -3), stats, hist)


def sharded_richardson_lucy(
    image,
    u,
    psf,
    top: int,
    bottom: int,
    left: int,
    right: int,
    tau: float,
    *,
    mesh,
    axis: str = "tile",
    iterations: int = 200,
    step_factor: float = 1e-3,
    lambd: float = 10000.0,
    blind: bool = True,
    correlation: bool = False,
    config: RLConfig | None = None,
    verbose: bool = False,
    use_stopping: bool = True,
) -> RLResult:
    """Run the RL-MM solver with the image's rows split across ``mesh``'s
    ``axis``; every rank returns the same ``RLResult``.

    Each rank runs the op loop on its rows (never the one-launch K2): halos
    of mk//2 rows before each 'valid' and 'full' convolution and each TV
    stencil, per-channel maxima over the owned rows combined with a MAX
    all-reduce, the blind PSF gradient (K3) as per-rank parts summed in
    rank order, the mask window gathered whole on every rank for the stop
    test, the stats and ``record_metrics``.  Uneven row counts are fine.
    """
    cfg = config or RLConfig()
    shard = RowShard(mesh.get_group(axis), u.shape[0], image.shape[0])
    u_out, u_full, psf_out, image_out, stats, hist = solve_rows(
        image, u, psf, whiteness_weights(bottom - top, right - left), shard, _mesh_device(mesh),
        top=int(top), bottom=int(bottom), left=int(left), right=int(right),
        tau=float(tau), step_factor=float(step_factor), lambd=float(lambd),
        iterations=int(iterations), blind=bool(blind), correlation=bool(correlation),
        use_tv=cfg.use_tv, tv_method=cfg.tv_method, tv_norm=cfg.tv_norm,
        conv_method=cfg.conv_method, conv_precision=cfg.conv_precision,
        psf_grad=cfg.psf_grad, inner_loop="xla", dtype=cfg.dtype,
        dof_guard=cfg.dof_guard, early_stop=cfg.early_stop,
        early_stop_patience=cfg.early_stop_patience, use_stopping=bool(use_stopping),
        record=cfg.record_metrics,
    )
    res = RLResult(u=u_out, psf=psf_out, image=image_out, stats=stats, u_full=u_full)
    if cfg.record_metrics:
        res.trajectory = {k: v.cpu().numpy() for k, v in hist.items()}
    if verbose:
        print_solver_report(res, lambd, top, bottom, left, right)
    return res
