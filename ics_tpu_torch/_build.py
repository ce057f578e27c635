"""Build and load the port's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  ``nvcc`` compiles
each one to an object file, all started together, then links them into one
shared library, loaded with ``ctypes``.  The build runs at first use (never
at import: machines without a GPU import every module), is keyed by a hash
of the sources and flags, and lands in ``build_dir()``: ``_build/`` beside
this file, which ``.gitignore`` lists, unless
``utils.cache.enable_persistent_cache`` named another directory before the
first build (a read-only install builds elsewhere that way).

No ``--use_fast_math``: the solver's DoF term divides by ``gradu + image``
with no epsilon (ics_tpu/models/rl_mm.py:413), so approximate division or
flushed denormals would leave the parity class of the JAX reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load_library", "check", "build_seconds", "build_dir", "set_build_dir", "loaded"]

_CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_build_dir = DEFAULT_BUILD_DIR  # where this library and the C++ runtime are built
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# every entry returns cudaGetLastError() after its launch
_SIGNATURES = {
    # a, taps, out, C, H, W, MK, NK, plo, qlo, Ho, Wo, stream
    "ics_conv2d": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # u, err, partial, out, C, uM, uN, M, N, inst, tb, tr, ws, n_strips,
    # stage_w, band_rows, n_bands, grid, smem (ops/cuda_correlate.py::geometry),
    # stream
    "ics_psf_grad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _P],
    # per_sm (out), inst, tb
    "ics_psf_grad_occupancy": [ctypes.POINTER(_I), _I, _I],
    # n_blocks (out), device
    "ics_inner_loop_blocks": [ctypes.POINTER(_I), _I],
    # u, image, psf_in, psf_out, err, ut, greg, dof, partial,
    # C, uM, uN, M, N, mk, step_factor, lambd, inv_un, inv_un3,
    # blind, correlation, n_blocks, stream
    "ics_inner_loop": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _F, _F, _F, _F,
                       _I, _I, _I, _P],
    # a, taps, out, C, H, W, MK, NK, plo, qlo, Ho, Wo,
    # inst, tile_rows, grid, smem (ops/cuda_conv_mma.py::geometry), stream
    "ics_conv_mma_split": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "ics_conv_mma_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "ics_conv_mma_highest": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P],
    "ics_conv_mma_default": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P],
    # u, tv, div, C, H, W, order, norm, eps, eps2, sqrt2, adjust, is_bf16, stream
    "ics_tv": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P],
    # src, out, C, H, W, radius, s, a (ops/cuda_bilateral.py::_kernel_constants),
    # stream
    "ics_bilateral": [_P, _P, _I, _I, _I, _I, _F, _F, _P],
    # m_r_new, mr, ints, go, iterations, blind, tau, early, keep, patience,
    # use_stopping, stream (ops/cuda_outer.py)
    "ics_outer_stop": [_P, _P, _P, _P, _I, _I, _F, _I, _F, _I, _I, _P],
    # body (cudaGraph_t), go, runs, stamps (or null), graph (out), exec (out)
    # (ops/cuda_outer.py)
    "ics_while_build": [_P, _P, _P, _P, ctypes.POINTER(_P), ctypes.POINTER(_P)],
    # graph (cudaGraph_t), counts (out: kernel, memcpy, memset, other)
    "ics_graph_nodes": [_P, ctypes.POINTER(_I)],
    # buf, index, count, stream (utils/trace.py)
    "ics_stamp": [_P, _I, _I, _P],
    # exec, stream
    "ics_while_launch": [_P, _P],
    # graph, exec
    "ics_while_free": [_P, _P],
    # src, dst, start, count, weights (ops/cuda_resize.py), outer, n_in, n_out, inner,
    # stream
    "ics_resample": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # gradu, u, ut, image, out, partial, C, uM, uN, M, N, pad, blocks, chunk,
    # lambd, inv_lambd, sf, inv_un, eps, blind, stream (ops/cuda_step.py)
    "ics_mm_step": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                    _F, _F, _F, _F, _F, _I, _P],
    # driver (out), runtime (out)
    "ics_cuda_versions": [ctypes.POINTER(_I), ctypes.POINTER(_I)],
}

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None  # wall time of this process's build


def build_dir() -> Path:
    """The directory that holds the kernels' and the runtime's builds."""
    return _build_dir


def set_build_dir(path) -> None:
    """Build into ``path`` from now on (``utils.cache.enable_persistent_cache``
    checks that nothing is loaded yet)."""
    global _build_dir
    _build_dir = Path(path)


def loaded() -> bool:
    """Whether this process has loaded the kernel library."""
    return _lib is not None


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sources + sorted(_CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _finish(cmd: list[str], output: str, returncode: int) -> None:
    if returncode != 0:
        raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n" + output)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load ``libics_kernels.so``."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        out_dir = _build_dir / _digest(sources)
        so = out_dir / "libics_kernels.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            nvcc, tag = _nvcc(), os.getpid()
            t0 = time.perf_counter()
            objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
            procs = [
                (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
                for cmd in (
                    [nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objs)
                )
            ]
            # wait for every compile before reporting the first failure
            done = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
            for result in done:
                _finish(*result)
            tmp = out_dir / f"libics_kernels.{tag}.so"
            cmd = [nvcc, *_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            _finish(cmd, proc.stdout, proc.returncode)
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (its cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
