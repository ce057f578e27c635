"""K7: the solvers' outer-loop stop on the device (csrc/outer_loop.cu) and its
plain twin; K7w and the WHILE graph that runs a solve's outers after the
first as one launch (csrc/graph_while.cu).

Counterpart of the stop of ics_tpu/models/rl_mm.py's ``lax.while_loop``
(:543-575 and ``outer_cond`` :598-600), which the TPU decides inside its
jitted program.  The state lives in three tensors on the solve's device,
updated in place so that a captured CUDA graph reads and writes it at fixed
addresses:

* ``mr``: float32 (3,), ``[m_r, m_r_prev, m_r_best]``;
* ``ints``: int32 (4,), ``[it, since_best, stop, go]``: one host read of it
  tells the outer count and whether another outer runs;
* ``go``: a 0-d bool, the same ``go``, that K7w hands to the WHILE node.

On CPU tensors ``outer_stop`` runs ``outer_stop_plain``; on CUDA tensors it
launches the kernel or raises.  ``while_build`` wraps a captured outer body
(``torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()``) in the graph
``K7w -> WHILE { body -> K7w }``; ``while_launch`` runs it.  K7w counts its
own runs in an int32 on the card (``runs``), which the caller reads with the
state and adds to ``while_launches``; given a tracer's ``stamps`` buffer it
also stamps the card's clock at each run (utils/trace.py).  K7w has no plain
twin: on the CPU the host loop reads ``go`` itself (models/rl_mm.py).
``graph_nodes`` counts a captured body's nodes by type.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ics_tpu_torch import _build

__all__ = ["initial_state", "outer_stop", "outer_stop_plain", "while_build", "while_launch",
           "while_free", "graph_nodes", "cuda_versions"]

launches = 0  # kernel launches by outer_stop (the twin never counts)
# K7w launches: a WHILE launch runs K7w once before its node and once after
# each body, each run adding one to the launch's ``runs`` on the card; the
# caller adds that count here once it has read it (models/rl_mm.py)
while_launches = 0


def initial_state(device, iterations: int):
    """``(mr, ints, go)`` before the first outer: M_r 0, its best +inf, the
    count 0, ``go`` while ``iterations`` > 0 (rl_mm.py:612-625)."""
    mr = torch.tensor([0.0, 0.0, float("inf")], dtype=torch.float32, device=device)
    ints = torch.tensor([0, 0, 0, int(iterations > 0)], dtype=torch.int32, device=device)
    return mr, ints, ints[3].bool()


def outer_stop_plain(m_r_new, mr, ints, go, *, iterations, blind, tau, early_stop=0.0,
                     patience=10, use_stopping=True) -> None:
    """K7's plain twin: the stop state machine in PyTorch on 0-d tensors, in
    place, with K7's float32 roundings.  Every outer loop of the solvers
    (models/rl_mm.py) stops through ``outer_stop``, on K7 or on this; none
    has stop operations of its own."""
    it = ints[0]
    if use_stopping:
        prev = torch.where(it > 0, mr[0], mr[1])
        if blind:
            hit = m_r_new > prev
        else:
            hit = (m_r_new - prev) / (m_r_new + prev) > tau
        stop = (it > 1) & hit
        if early_stop > 0.0 and not blind:
            improved = m_r_new < mr[2] * (1.0 - early_stop)
            mr[2] = torch.where(improved, m_r_new, mr[2])
            ints[1] = torch.where(improved, 0, ints[1] + 1)
            stop = stop | ((it > 1) & (ints[1] >= patience))
        mr[0], mr[1] = m_r_new, prev
    else:
        stop = torch.zeros((), dtype=torch.bool, device=ints.device)
    ints[0] += 1
    ints[2] = stop
    ints[3] = (ints[0] < iterations) & ~stop
    go.copy_(ints[3])


def outer_stop(m_r_new, mr, ints, go, *, iterations, blind, tau, early_stop=0.0, patience=10,
               use_stopping=True) -> None:
    """One outer's stop, in place on ``(mr, ints, go)``: K7 on CUDA tensors,
    the plain twin on CPU ones."""
    global launches
    kw = dict(iterations=iterations, blind=blind, tau=tau, early_stop=early_stop,
              patience=patience, use_stopping=use_stopping)
    if ints.device.type == "cpu":
        return outer_stop_plain(m_r_new, mr, ints, go, **kw)
    if ints.device.type != "cuda":
        raise ValueError(f"unsupported device {ints.device}")
    want = ((m_r_new, torch.float32, ()), (mr, torch.float32, (3,)),
            (ints, torch.int32, (4,)), (go, torch.bool, ()))
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != ints.device:
            raise ValueError(f"K7 takes m_r_new f32 (), mr f32 (3,), ints int32 (4,) and go "
                             f"bool () on one device; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not (mr.is_contiguous() and ints.is_contiguous()):
        raise ValueError("K7 needs contiguous mr and ints")
    rc = _build.load_library().ics_outer_stop(
        m_r_new.data_ptr(), mr.data_ptr(), ints.data_ptr(), go.data_ptr(),
        int(iterations), int(bool(blind)), float(np.float32(tau)),
        int(early_stop > 0.0 and not blind), float(np.float32(1.0 - early_stop)),
        int(patience), int(bool(use_stopping)),
        torch.cuda.current_stream(ints.device).cuda_stream,
    )
    _build.check(rc, "ics_outer_stop")
    launches += 1


def while_build(body_graph: int, go, runs, stamps=None) -> tuple[int, int]:
    """The outer graph ``K7w(go) -> WHILE { body -> K7w(go) }`` around the
    captured ``body_graph`` (a ``cudaGraph_t``), instantiated: returns its
    (graph, executable) handles for ``while_launch`` and ``while_free``.
    ``go`` is the state's bool that the body's K7 writes; ``runs`` a
    one-element int32 on the same device that every run of K7w adds one
    to, from 0; ``stamps``: None, or a contiguous int64 on that device with
    room for every run of K7w, into which each run writes the card's
    %globaltimer at index ``runs`` (the graph's nodes are the same either
    way).  Raises when a step fails: there is no other route."""
    if go.device.type != "cuda" or go.dtype != torch.bool or go.dim() != 0:
        raise ValueError(f"the WHILE graph's go is a 0-d bool on a CUDA device; got {go.dtype} "
                         f"{tuple(go.shape)} on {go.device}")
    if runs.device != go.device or runs.dtype != torch.int32 or runs.numel() != 1:
        raise ValueError(f"K7w's runs is one int32 on go's device; got {runs.dtype} "
                         f"{tuple(runs.shape)} on {runs.device}")
    if stamps is not None and (stamps.device != go.device or stamps.dtype != torch.int64
                               or stamps.dim() != 1 or not stamps.is_contiguous()):
        raise ValueError(f"K7w's stamps are a contiguous 1-d int64 on go's device; got "
                         f"{stamps.dtype} {tuple(stamps.shape)} on {stamps.device}")
    graph, exe = ctypes.c_void_p(), ctypes.c_void_p()
    at = stamps.data_ptr() if stamps is not None else None
    rc = _build.load_library().ics_while_build(body_graph, go.data_ptr(), runs.data_ptr(), at,
                                               ctypes.byref(graph), ctypes.byref(exe))
    if rc != 0:
        raise RuntimeError(f"ics_while_build: CUDA error {rc} building or instantiating the "
                           "WHILE graph")
    return graph.value, exe.value


def while_launch(handles: tuple[int, int], device) -> None:
    """One launch of the WHILE graph on the current stream of ``device``."""
    rc = _build.load_library().ics_while_launch(
        handles[1], torch.cuda.current_stream(device).cuda_stream)
    _build.check(rc, "ics_while_launch")


def while_free(graph: int, exe: int) -> None:
    """Destroy the WHILE graph and its executable (one still running is
    freed when it completes)."""
    rc = _build.load_library().ics_while_free(graph, exe)
    if rc != 0:
        raise RuntimeError(f"ics_while_free: CUDA error {rc}")


NODE_TYPES = ("kernel", "memcpy", "memset", "other")


def graph_nodes(graph: int) -> dict[str, int]:
    """The nodes of ``graph`` (a ``cudaGraph_t``, as a captured body's
    ``raw_cuda_graph()``) by type, keyed by ``NODE_TYPES``; 'other' counts
    events, waits, host calls, child graphs and conditionals."""
    counts = (ctypes.c_int * 4)()
    rc = _build.load_library().ics_graph_nodes(graph, counts)
    if rc != 0:
        raise RuntimeError(f"ics_graph_nodes: CUDA error {rc}")
    return dict(zip(NODE_TYPES, counts))


def cuda_versions() -> tuple[int, int]:
    """(driver, runtime) CUDA versions as ``cudaDriverGetVersion`` and the
    kernel library's ``cudaRuntimeGetVersion`` give them (12030 is 12.3)."""
    driver, runtime = ctypes.c_int(), ctypes.c_int()
    rc = _build.load_library().ics_cuda_versions(ctypes.byref(driver), ctypes.byref(runtime))
    _build.check(rc, "ics_cuda_versions")
    return driver.value, runtime.value
