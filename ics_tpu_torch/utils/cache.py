"""Where the port keeps what it compiles (counterpart of
ics_tpu/utils/cache.py).

The JAX package turns on XLA's persistent compilation cache, so each program
shape compiles once per machine.  The port compiles nothing per shape: its
CUDA kernels (``_build.py``) and its C++ runtime (``runtime/_lib.py``) are
each built once per source hash, at first use, into one directory, and
found there by every later process.  This sets that directory.  The default
is ``ics_tpu_torch/_build/`` beside the sources; a read-only install names a
writable one.
"""

from __future__ import annotations

from pathlib import Path

from ics_tpu_torch import _build

__all__ = ["enable_persistent_cache"]

DEFAULT_CACHE_DIR = str(_build.DEFAULT_BUILD_DIR)


def enable_persistent_cache(path: str | None = None, min_compile_secs: float = 1.0) -> None:
    """Build the kernels and the runtime into ``path`` and reuse what is
    there.  ``None`` keeps the directory in use: ``DEFAULT_CACHE_DIR``
    unless a caller named another, so the CLI's call leaves a caller's
    choice alone.  ``min_compile_secs`` is accepted for the JAX signature:
    every build is kept, because each takes seconds.  Naming the directory
    in use again does nothing; naming another after this process has loaded
    the kernels or the runtime raises ``RuntimeError``, since the loaded
    libraries stay where they are."""
    from ics_tpu_torch.runtime import _lib as runtime

    if path is None or Path(path) == _build.build_dir():
        return
    if _build.loaded() or runtime.loaded():
        raise RuntimeError(
            f"enable_persistent_cache({str(path)!r}) after the kernels or the runtime were "
            f"loaded from {_build.build_dir()}: call it before their first use"
        )
    _build.set_build_dir(Path(path))
