"""K7: the RL-MM outer loop's stop on the device (csrc/outer_loop.cu) and its
plain twin.

Counterpart of the stop of ics_tpu/models/rl_mm.py's ``lax.while_loop``
(:543-575 and ``outer_cond`` :598-600), which the TPU decides inside its
jitted program.  The state lives in three tensors on the solve's device,
updated in place so that a captured CUDA graph reads and writes it at fixed
addresses:

* ``mr``: float32 (3,), ``[m_r, m_r_prev, m_r_best]``;
* ``ints``: int32 (4,), ``[it, since_best, stop, go]``: one host read of it
  tells the outer count and whether another outer runs;
* ``go``: a 0-d bool, the same ``go``, for a graph's conditional node.

On CPU tensors ``outer_stop`` runs ``outer_stop_plain``; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ics_tpu_torch import _build

__all__ = ["initial_state", "outer_stop", "outer_stop_plain"]

launches = 0  # kernel launches by outer_stop (the twin never counts)


def initial_state(device, iterations: int):
    """``(mr, ints, go)`` before the first outer: M_r 0, its best +inf, the
    count 0, ``go`` while ``iterations`` > 0 (rl_mm.py:612-625)."""
    mr = torch.tensor([0.0, 0.0, float("inf")], dtype=torch.float32, device=device)
    ints = torch.tensor([0, 0, 0, int(iterations > 0)], dtype=torch.int32, device=device)
    return mr, ints, ints[3].bool()


def outer_stop_plain(m_r_new, mr, ints, go, *, iterations, blind, tau, early_stop=0.0,
                     patience=10, use_stopping=True) -> None:
    """The stop state machine in PyTorch on 0-d tensors, in place: the same
    operations as the solver's Python loop (models/rl_mm.py::whiteness_stop
    and its plateau test), hence the same float32 roundings."""
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
