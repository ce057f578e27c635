"""Build and load ``libics_runtime.so`` (the codecs and the prefetcher).

The sources under ``src/`` have a plain C interface.  One host C++ compiler
call builds them into a shared library at first use (never at import), in
a directory keyed by a hash of the sources, the compiler and the flags,
under the directory that also holds the CUDA kernels
(``ics_tpu_torch/_build.py::build_dir``: ``ics_tpu_torch/_build/``, which
``.gitignore`` lists, unless ``utils.cache.enable_persistent_cache`` named
another).  No CMake and
no ninja: a host compiler is all the build needs.

The compiler is ``$CXX``, else ``c++``, else ``g++``.  Without one,
``load()`` returns ``None`` and the bindings report ``available() ->
False`` (the TIFF coders then run in Python); a compile error raises with
the compiler's output.  A missing compiler is not remembered, so a library
built later in the process is found.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ics_tpu_torch import _build

__all__ = ["compiler", "build", "load", "loaded", "build_seconds"]

_SRC = Path(__file__).resolve().parent / "src"
_FLAGS = ["-std=c++17", "-O3", "-fno-exceptions", "-fvisibility=hidden", "-fPIC",
          "-shared", "-pthread"]
_NAME = "libics_runtime.so"

_P, _L = ctypes.c_void_p, ctypes.c_longlong
# name: (restype, argtypes)
_CODER = (_L, [ctypes.c_char_p, _L, ctypes.c_char_p, _L])  # src, srclen, dst, dstlen
_SIGNATURES = {
    "ics_decode_packbits": _CODER,
    "ics_decode_lzw": _CODER,
    "ics_encode_packbits": _CODER,
    "ics_encode_lzw": _CODER,
    "ics_loader_create": (_P, [ctypes.c_int]),
    "ics_loader_submit": (_L, [_P, ctypes.c_char_p]),
    "ics_loader_size": (_L, [_P, _L]),
    "ics_loader_take": (_L, [_P, _L, ctypes.c_char_p, _L]),
    "ics_loader_destroy": (None, [_P]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's last compile


def compiler() -> list[str] | None:
    """The host C++ compiler's command (``$CXX``, ``c++``, ``g++``), or
    ``None`` when there is none."""
    cxx = os.environ.get("CXX")
    candidates = [shlex.split(cxx)] if cxx else [["c++"], ["g++"]]
    for cmd in candidates:
        if cmd and shutil.which(cmd[0]):
            return cmd
    return None


def _sources(src_dir: Path) -> list[Path]:
    return sorted(Path(src_dir).glob("*.cpp"))


def _digest(sources: list[Path], cxx: list[str]) -> str:
    h = hashlib.sha256(" ".join(cxx + _FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(src_dir=_SRC, out_root=None) -> Path:
    """Compile every ``*.cpp`` of ``src_dir`` into one shared library under
    ``out_root`` (default ``_build.build_dir()``; once per hash) and return
    its path.  Raises ``RuntimeError`` with the compiler's output when the
    compile fails, and when there is no compiler."""
    global build_seconds
    if out_root is None:
        out_root = _build.build_dir()
    cxx = compiler()
    sources = _sources(src_dir)
    if not sources:
        raise RuntimeError(f"no C++ sources in {src_dir}")
    if cxx is None:
        raise RuntimeError("no C++ compiler: set CXX or put c++ or g++ on PATH")
    out_dir = Path(out_root) / f"runtime-{_digest(sources, cxx)}"
    so = out_dir / _NAME
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{_NAME}.{os.getpid()}.{threading.get_ident()}"
    cmd = [*cxx, *_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError("C++ compile failed:\n" + " ".join(cmd) + "\n" + proc.stdout)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    build_seconds = time.perf_counter() - t0
    return so


def loaded() -> bool:
    """Whether this process has loaded the runtime library."""
    return _lib is not None


def load() -> ctypes.CDLL | None:
    """The loaded library, built at the first call; ``None`` only when
    there is no C++ compiler."""
    global _lib
    with _lock:
        if _lib is None and compiler() is not None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib
