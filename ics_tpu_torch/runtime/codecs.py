"""ctypes bindings of the native LZW and PackBits coders (``src/codecs.cpp``).

Copied from ics_tpu/runtime/codecs.py, with the same functions and
signatures; the library is built at first use (``runtime/_lib.py``), not
looked up prebuilt.  Native counterparts of the reference's C TIFF codecs
(ref lib/tifffile.c:550 ``py_decodepackbits``, :658 ``py_decodelzw``).
``available()`` is ``False`` only on a host without a C++ compiler;
``ics_tpu_torch.utils.io`` then uses its pure-Python coders, which give the
same bytes.
"""

from __future__ import annotations

import ctypes

from ics_tpu_torch.runtime import _lib

__all__ = ["available", "has_encoders", "decode_packbits", "decode_lzw",
           "encode_packbits", "encode_lzw"]


def available() -> bool:
    return _lib.load() is not None


def has_encoders() -> bool:
    """The port's library always has them (the JAX bindings' check for an
    older prebuilt library)."""
    return available()


def _run(fname: str, data: bytes, cap: int) -> bytes:
    lib = _lib.load()
    if lib is None:
        raise RuntimeError("the native runtime needs a C++ compiler (set CXX)")
    size = len(data)
    if not isinstance(data, bytes):  # a bytearray (the prefetcher's): no copy
        data = (ctypes.c_char * size).from_buffer(data)
    out = ctypes.create_string_buffer(cap)
    n = getattr(lib, fname)(data, size, out, cap)
    if n < 0:
        raise ValueError(f"{fname} failed")
    return out.raw[:n]


def decode_packbits(data: bytes, expected: int) -> bytes:
    return _run("ics_decode_packbits", data, expected)


def decode_lzw(data: bytes, expected: int) -> bytes:
    return _run("ics_decode_lzw", data, expected)


def encode_packbits(data: bytes) -> bytes:
    # worst case: one header byte per 128 literals, plus slack
    return _run("ics_encode_packbits", data, len(data) + len(data) // 128 + 16)


def encode_lzw(data: bytes) -> bytes:
    # worst case ~12 bits per input byte (all-literal, max width) plus slack
    return _run("ics_encode_lzw", data, 2 * len(data) + 64)
