"""The native host tier (counterpart of ics_tpu/runtime/): the LZW and
PackBits TIFF coders (``codecs``) and the thread-pool file prefetcher
(``loader``), one small C++ library bound with ctypes.

The library is built from ``src/`` with the host C++ compiler at first use,
into ``ics_tpu_torch/_build/`` (``_lib.py``); nothing is built at import.
"""

from ics_tpu_torch.runtime import codecs, loader

__all__ = ["codecs", "loader"]
