"""Image I/O: 16-bit TIFF save (the reference's only output path) and
JPEG/TIFF input (host-side NumPy).

Copied from ics_tpu/utils/io.py: the port never imports ``ics_tpu``, whose
package import loads JAX.  The copy keeps the file's own pure-Python codecs
and the serial ``imread_sequence``; the JAX package's native C++ codecs and
prefetcher (``ics_tpu.runtime``) are not ported yet (ROADMAP item 5).

Parity targets: reference lib/utils.py:303-312 (``save`` → 16-bit RGB TIFF)
and the vendored ``lib/tifffile.py`` read/write stack (C12 in SURVEY.md §2).
This environment has no ``tifffile`` package, so a self-contained TIFF
implementation lives here: read classic TIFF and BigTIFF, strip or tile
layout, uncompressed / PackBits / LZW / Deflate (zlib) / LZMA / new-style
JPEG (via PIL's libjpeg), 8/16-bit, both byte orders, with
horizontal-predictor support; write classic TIFF with optional
LZW, PackBits, Deflate or LZMA compression; ``imread_sequence`` stacks a
glob of
files (the
``TiffSequence`` analog, ref lib/tifffile.py:4073).  The LZW and PackBits
coders are pure Python, byte-identical to the JAX package's native ones
(counterparts of the reference's hand-written lib/tifffile.c:432-658).

I/O is host-side by design — the GPU sees only device tensors.  PIL is
imported lazily, only for non-TIFF input and JPEG-compressed TIFF pages.
"""

from __future__ import annotations

import os
import struct
import sys
from os.path import join

import numpy as np

__all__ = [
    "save",
    "imsave",
    "imsave_pages",
    "imsave_bigtiff",
    "imsave_tiled",
    "imsave_imagej",
    "imread",
    "imread_sequence",
    "read_description",
    "memmap_create",
    "load_image",
]

# TIFF tag ids
_NEW_SUBFILE_TYPE = 254
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_IMAGE_DESCRIPTION = 270
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_SAMPLE_FORMAT = 339
_PREDICTOR = 317
_EXTRA_SAMPLES = 338


def save(pic: np.ndarray, name: str, dest_path: str) -> None:
    """Save as 16-bit RGB TIFF (parity: ref lib/utils.py:303-312)."""
    imsave(join(dest_path, name + ".tif"), np.asarray(pic).astype(np.uint16))


def _encode_packbits_py(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out.append(257 - run)
            out.append(data[i])
            i += run
        else:
            j = i + 1
            while j < n and j - i < 128:
                r = 1
                while j + r < n and r < 3 and data[j + r] == data[j]:
                    r += 1
                if r >= 3:
                    break
                j += 1
            out.append(j - i - 1)
            out += data[i:j]
            i = j
    return bytes(out)


def _encode_lzw_py(data: bytes) -> bytes:
    """TIFF-variant LZW compression (inverse of ``_decode_lzw``)."""
    out = bytearray()
    bitbuf = bitcnt = 0
    nbits = 9
    next_code = 258
    table: dict[int, int] = {}

    def put(code):
        nonlocal bitbuf, bitcnt
        bitbuf = (bitbuf << nbits) | code
        bitcnt += nbits
        while bitcnt >= 8:
            out.append((bitbuf >> (bitcnt - 8)) & 0xFF)
            bitcnt -= 8
        bitbuf &= (1 << bitcnt) - 1

    put(256)  # Clear
    if data:
        cur = data[0]
        for b in data[1:]:
            key = (cur << 8) | b
            code = table.get(key)
            if code is not None:
                cur = code
                continue
            put(cur)
            table[key] = next_code
            next_code += 1
            cur = b
            # early change (libtiff convention): the encoder runs one
            # entry ahead of the decoder, so it widens at 2^nbits
            if next_code >= (1 << nbits) and nbits < 12:
                nbits += 1
            if next_code >= 4094:
                put(256)
                table = {}
                next_code = 258
                nbits = 9
        put(cur)
    put(257)  # EOI
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)


def _compress(data: bytes, compression: str | None) -> tuple[bytes, int]:
    """Returns (payload, TIFF compression tag value)."""
    if compression in (None, "none", 1):
        return data, 1
    if compression in ("lzw", 5):
        return _encode_lzw_py(data), 5
    if compression in ("packbits", 32773):
        return _encode_packbits_py(data), 32773
    if compression in ("deflate", "zip", "adobe_deflate", 8, 32946):
        # Adobe Deflate (tag 8): a plain zlib stream (ref
        # lib/tifffile.py:914, 5245 — TIFF.COMPRESSION ZIP/ADOBE_DEFLATE).
        # The stdlib zlib module wraps the same C library libtiff uses.
        import zlib

        return zlib.compress(data, 6), 8
    if compression in ("lzma", 34925):
        # LZMA2 (tag 34925).  The reference stack reads this when the
        # stdlib lzma module exists (ref lib/tifffile.py:5249-5250) but
        # cannot write it; kept for round-trip symmetry with our reader.
        import lzma

        return lzma.compress(data), 34925
    raise ValueError(f"unsupported compression {compression!r}")


def _page_meta(arr: np.ndarray) -> dict:
    """Validate dtype/shape of one page; dimensions + TIFF field values."""
    if arr.dtype not in (
        np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.float32)
    ):
        raise ValueError(f"imsave supports uint8/uint16/float32, got {arr.dtype}")
    sample_format = 3 if arr.dtype.kind == "f" else 1
    if arr.ndim == 2:
        h, w, spp = arr.shape[0], arr.shape[1], 1
        photometric = 1  # BlackIsZero
    elif arr.ndim == 3 and arr.shape[2] in (1, 3, 4):
        h, w, spp = arr.shape
        photometric = 2 if spp >= 3 else 1
    else:
        raise ValueError(f"unsupported shape {arr.shape}")
    return {
        "h": h, "w": w, "spp": spp, "photometric": photometric,
        "bps": arr.dtype.itemsize * 8, "sample_format": sample_format,
    }


def _plan_page(arr: np.ndarray, compression, description: str | None = None):
    """Validate one page and precompute everything its IFD needs."""
    arr = np.ascontiguousarray(arr)
    meta = _page_meta(arr)
    h, w, spp = meta["h"], meta["w"], meta["spp"]
    photometric = meta["photometric"]
    sample_format = meta["sample_format"]
    data = arr.astype("<" + arr.dtype.str[1:]).tobytes()
    data, comp_tag = _compress(data, compression)
    desc = None
    if description is not None:
        desc = description.encode("utf-8")
        if not desc.endswith(b"\0"):
            desc += b"\0"  # TIFF ASCII values are NUL-terminated
    plan = {
        "h": h, "w": w, "spp": spp, "photometric": photometric,
        "bps": arr.dtype.itemsize * 8, "sample_format": sample_format,
        "data": data, "comp_tag": comp_tag, "desc": desc,
        "n_entries": 11
        + (1 if (photometric == 2 and spp == 4) else 0)
        + (1 if desc is not None else 0),
        "extra_len": ((2 * spp * 2) if spp * 2 > 4 else 0)
        + (len(desc) if desc is not None and len(desc) > 4 else 0),
    }
    plan["ifd_size"] = 2 + plan["n_entries"] * 12 + 4
    plan["seg_len"] = plan["ifd_size"] + plan["extra_len"] + len(data)
    return plan


def _emit_page(plan, seg_off: int, next_ifd_off: int) -> bytes:
    """Serialize one page segment ([IFD][extra arrays][pixel data]) laid
    out at absolute offset ``seg_off``; the IFD's next pointer is
    ``next_ifd_off`` (0 on the last page of the chain)."""
    h, w, spp = plan["h"], plan["w"], plan["spp"]
    data = plan["data"]
    entries = [
        (_IMAGE_WIDTH, 4, 1, w),
        (_IMAGE_LENGTH, 4, 1, h),
        (_BITS_PER_SAMPLE, 3, spp, None),  # value resolved below
        (_COMPRESSION, 3, 1, plan["comp_tag"]),
        (_PHOTOMETRIC, 3, 1, plan["photometric"]),
        (_STRIP_OFFSETS, 4, 1, None),
        (_SAMPLES_PER_PIXEL, 3, 1, spp),
        (_ROWS_PER_STRIP, 4, 1, h),
        (_STRIP_BYTE_COUNTS, 4, 1, len(data)),
        (_PLANAR_CONFIG, 3, 1, 1),
        (_SAMPLE_FORMAT, 3, spp, None),
    ]
    if plan["photometric"] == 2 and spp == 4:
        # TIFF 6.0 requires ExtraSamples for channels beyond RGB;
        # 2 = unassociated alpha (what PIL/libtiff expect for RGBA)
        entries.append((_EXTRA_SAMPLES, 3, 1, 2))
    desc = plan.get("desc")
    if desc is not None:
        entries.append((_IMAGE_DESCRIPTION, 2, len(desc), None))
    entries.sort()  # IFD entries must be in ascending tag order
    # extra arrays (bits-per-sample / sample-format lists) go after the IFD
    extra_off = seg_off + plan["ifd_size"]
    extra = b""
    resolved = []
    for tag, typ, count, value in entries:
        if tag == _BITS_PER_SAMPLE:
            if spp * 2 <= 4:
                value = plan["bps"]
            else:
                value = extra_off + len(extra)
                extra += struct.pack(f"<{spp}H", *([plan["bps"]] * spp))
        elif tag == _SAMPLE_FORMAT:
            if spp * 2 <= 4:
                value = plan["sample_format"]
            else:
                value = extra_off + len(extra)
                extra += struct.pack(
                    f"<{spp}H", *([plan["sample_format"]] * spp)
                )
        elif tag == _IMAGE_DESCRIPTION:
            if len(desc) <= 4:
                value = desc  # inline ASCII bytes
            else:
                value = extra_off + len(extra)
                extra += desc
        resolved.append((tag, typ, count, value))
    data_off = extra_off + len(extra)
    resolved = [
        (tag, typ, count, data_off if tag == _STRIP_OFFSETS else value)
        for tag, typ, count, value in resolved
    ]

    ifd = struct.pack("<H", len(resolved))
    for tag, typ, count, value in resolved:
        if isinstance(value, bytes):
            payload = value.ljust(4, b"\0")
        elif typ == 3 and count == 1:
            payload = struct.pack("<HH", value, 0)
        else:
            payload = struct.pack("<I", value)
        ifd += struct.pack("<HHI", tag, typ, count) + payload
    ifd += struct.pack("<I", next_ifd_off)
    return ifd + extra + data


def imsave(
    path: str,
    arr: np.ndarray,
    compression: str | None = None,
    description: str | None = None,
) -> None:
    """Write a baseline little-endian TIFF (chunky, single strip).

    Supports (H, W) and (H, W, C) uint8/uint16/float32 arrays (float
    pages get SampleFormat 3, which our reader and libtiff both honor);
    ``compression``: None | 'lzw' | 'packbits' | 'deflate' (= 'zip',
    Adobe Deflate tag 8) | 'lzma' (tag 34925; LZW/PackBits are pure
    Python, Deflate/LZMA are stdlib zlib/lzma).
    ``description`` writes an
    ImageDescription tag (how ImageJ / OME metadata travel in TIFFs).
    """
    plan = _plan_page(arr, compression, description)
    header = struct.pack("<2sHI", b"II", 42, 8)
    with open(path, "wb") as f:
        f.write(header + _emit_page(plan, 8, 0))


def imsave_bigtiff(path: str, arr: np.ndarray, compression: str | None = None) -> None:
    """Write a single-page little-endian BigTIFF (the 8-byte-offset format
    for >4 GB files; ref lib/tifffile.py handles it via TiffWriter's
    bigtiff flag).  Same dtype/shape support as ``imsave``; our reader
    (BigTIFF path validated against hand-built fixtures) reads it back.

    BigTIFF inline value fields are 8 bytes, so the per-sample
    BitsPerSample / SampleFormat arrays fit inline for every supported
    spp — no external arrays needed."""
    plan = _plan_page(arr, compression)
    h, w, spp = plan["h"], plan["w"], plan["spp"]
    data = plan["data"]
    n = plan["n_entries"]
    header = struct.pack("<2sHHHQ", b"II", 43, 8, 0, 16)
    ifd_size = 8 + n * 20 + 8
    data_off = 16 + ifd_size

    entries = [
        (_IMAGE_WIDTH, 4, 1, struct.pack("<I", w)),
        (_IMAGE_LENGTH, 4, 1, struct.pack("<I", h)),
        (_BITS_PER_SAMPLE, 3, spp, struct.pack(f"<{spp}H", *([plan["bps"]] * spp))),
        (_COMPRESSION, 3, 1, struct.pack("<H", plan["comp_tag"])),
        (_PHOTOMETRIC, 3, 1, struct.pack("<H", plan["photometric"])),
        (_STRIP_OFFSETS, 16, 1, struct.pack("<Q", data_off)),
        (_SAMPLES_PER_PIXEL, 3, 1, struct.pack("<H", spp)),
        (_ROWS_PER_STRIP, 4, 1, struct.pack("<I", h)),
        (_STRIP_BYTE_COUNTS, 16, 1, struct.pack("<Q", len(data))),
        (_PLANAR_CONFIG, 3, 1, struct.pack("<H", 1)),
        (_SAMPLE_FORMAT, 3, spp,
         struct.pack(f"<{spp}H", *([plan["sample_format"]] * spp))),
    ]
    if plan["photometric"] == 2 and spp == 4:
        entries.append((_EXTRA_SAMPLES, 3, 1, struct.pack("<H", 2)))
        entries.sort()
    assert len(entries) == n
    body = struct.pack("<Q", n)
    for tag, typ, count, payload in entries:
        body += struct.pack("<HHQ", tag, typ, count) + payload.ljust(8, b"\0")
    body += struct.pack("<Q", 0)  # no next IFD
    with open(path, "wb") as f:
        f.write(header + body + data)


def imsave_pages(
    path: str,
    pages,
    compression: str | None = None,
    description: str | None = None,
) -> None:
    """Write a multi-page TIFF: ``pages`` is an (N, ...) stack or a list of
    per-page arrays (shapes/dtypes may differ page to page).  The written
    IFD chain round-trips through ``imread(pages=True)`` and libtiff —
    the writer-side analog of the reference's ``TiffWriter`` page loop
    (ref lib/tifffile.py:581).  ``description`` goes on the FIRST page
    (where ImageJ / OME-XML stack metadata live by convention)."""
    plans = [
        _plan_page(np.asarray(p), compression, description if i == 0 else None)
        for i, p in enumerate(pages)
    ]
    if not plans:
        raise ValueError("imsave_pages needs at least one page")
    header = struct.pack("<2sHI", b"II", 42, 8)
    offs = [8]
    for plan in plans[:-1]:
        offs.append(offs[-1] + plan["seg_len"])
    with open(path, "wb") as f:
        f.write(header)
        for i, plan in enumerate(plans):
            next_off = offs[i + 1] if i + 1 < len(plans) else 0
            f.write(_emit_page(plan, offs[i], next_off))


def imsave_imagej(path: str, stack: np.ndarray) -> None:
    """Write an (N, ...) frame stack in ImageJ's hyperstack layout: ONE
    IFD describing frame 0 with ``ImageJ= / images=N`` in the description,
    and all N frames contiguous after it (what ImageJ itself writes and
    what our ``imread(pages=True)`` / tifffile's ``is_imagej`` path read).
    Far cheaper than an N-page chain for large stacks: one IFD total."""
    stack = np.ascontiguousarray(stack)
    if stack.ndim not in (3, 4):
        raise ValueError(f"need an (N, H, W[, C]) stack, got {stack.shape}")
    n = stack.shape[0]
    desc = f"ImageJ=1.53t\nimages={n}\nslices={n}\nloop=false"
    imsave(path, stack[0], description=desc)
    if n > 1:
        with open(path, "ab") as f:
            f.write(stack[1:].astype("<" + stack.dtype.str[1:]).tobytes())


def imsave_tiled(
    path: str,
    arr: np.ndarray,
    tile: tuple[int, int] = (256, 256),
    compression: str | None = None,
) -> None:
    """Write a tiled classic TIFF (TIFF 6.0 §15) — the layout large-format
    pipelines use for random-access crops (the reference's vendored reader
    handles it via TiffPage tile decoding, ref lib/tifffile.py:2230; this is
    the writer-side counterpart; our ``imread`` tile path reads it back).

    ``tile`` is (tile_length, tile_width); TIFF 6.0 requires both to be
    multiples of 16.  Edge tiles are zero-padded to full tile size, as the
    spec mandates.  Same dtype/shape/compression support as ``imsave``.
    """
    arr = np.ascontiguousarray(arr)
    tl, tw = int(tile[0]), int(tile[1])
    if tl % 16 or tw % 16 or tl <= 0 or tw <= 0:
        raise ValueError(f"tile dims must be positive multiples of 16, got {tile}")
    meta = _page_meta(arr)
    h, w, spp = meta["h"], meta["w"], meta["spp"]
    chunky = arr.reshape(h, w, spp)
    tiles_down, tiles_across = -(-h // tl), -(-w // tw)
    payloads = []
    for ty in range(tiles_down):
        for tx in range(tiles_across):
            full = np.zeros((tl, tw, spp), dtype=arr.dtype)
            block = chunky[ty * tl : ty * tl + tl, tx * tw : tx * tw + tw]
            full[: block.shape[0], : block.shape[1]] = block
            data = full.astype("<" + arr.dtype.str[1:]).tobytes()
            payload, comp_tag = _compress(data, compression)
            payloads.append(payload)
    n_tiles = len(payloads)

    entries = [
        (_IMAGE_WIDTH, 4, 1, w),
        (_IMAGE_LENGTH, 4, 1, h),
        (_BITS_PER_SAMPLE, 3, spp, ("shorts", [meta["bps"]] * spp)),
        (_COMPRESSION, 3, 1, comp_tag),
        (_PHOTOMETRIC, 3, 1, meta["photometric"]),
        (_SAMPLES_PER_PIXEL, 3, 1, spp),
        (_PLANAR_CONFIG, 3, 1, 1),
        (_TILE_WIDTH, 4, 1, tw),
        (_TILE_LENGTH, 4, 1, tl),
        (_TILE_OFFSETS, 4, n_tiles, ("offsets", None)),
        (_TILE_BYTE_COUNTS, 4, n_tiles, ("longs", [len(p) for p in payloads])),
        (_SAMPLE_FORMAT, 3, spp, ("shorts", [meta["sample_format"]] * spp)),
    ]
    if meta["photometric"] == 2 and spp == 4:
        entries.append((_EXTRA_SAMPLES, 3, 1, 2))
    entries.sort()
    ifd_size = 2 + len(entries) * 12 + 4
    extra_off = 8 + ifd_size
    # first pass: lay out the external arrays to learn where tile data starts
    extra = b""
    for tag, typ, count, value in entries:
        if isinstance(value, tuple):
            kind, vals = value
            per = 2 if kind == "shorts" else 4
            if count * per > 4:
                extra += b"\0" * (count * per)
    data_off = extra_off + len(extra)
    tile_offs = []
    pos = data_off
    for p in payloads:
        tile_offs.append(pos)
        pos += len(p)

    extra = b""
    ifd = struct.pack("<H", len(entries))
    for tag, typ, count, value in entries:
        if isinstance(value, tuple):
            kind, vals = value
            if kind == "offsets":
                vals = tile_offs
            fmt, per = ("H", 2) if kind == "shorts" else ("I", 4)
            packed = struct.pack(f"<{count}{fmt}", *vals)
            if count * per <= 4:
                payload = packed.ljust(4, b"\0")
            else:
                payload = struct.pack("<I", extra_off + len(extra))
                extra += packed
        elif typ == 3:
            payload = struct.pack("<HH", value, 0)
        else:
            payload = struct.pack("<I", value)
        ifd += struct.pack("<HHI", tag, typ, count) + payload
    ifd += struct.pack("<I", 0)  # no next IFD
    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, 8) + ifd + extra)
        for p in payloads:
            f.write(p)


def memmap_create(path: str, shape, dtype=np.uint16) -> np.memmap:
    """Create a new single-page uncompressed TIFF of the given shape and
    return a WRITABLE ``np.memmap`` view of its pixel data — the analog of
    the reference's ``tifffile.memmap(..., mode='r+')`` creation path
    (ref lib/tifffile.py:479), which lets callers fill a result frame
    incrementally without materializing it in RAM.  Flush with
    ``.flush()``; read back with ``imread`` / ``imread(memmap=True)``."""
    shape = tuple(int(s) for s in shape)
    dt = np.dtype(dtype).newbyteorder("<")
    if dt.base not in (
        np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.float32)
    ) and np.dtype(dtype) not in (
        np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.float32)
    ):
        raise ValueError(f"memmap_create supports uint8/uint16/float32, got {dtype}")
    if len(shape) == 2:
        h, w, spp = shape[0], shape[1], 1
    elif len(shape) == 3 and shape[2] in (1, 3, 4):
        h, w, spp = shape
    else:
        raise ValueError(f"unsupported shape {shape}")
    nbytes = h * w * spp * dt.itemsize
    plan = {
        "h": h, "w": w, "spp": spp,
        "photometric": 2 if spp >= 3 else 1,
        "bps": dt.itemsize * 8,
        "sample_format": 3 if dt.kind == "f" else 1,
        # the pixel payload is written through the returned memmap, not
        # here — emit an empty data blob but a real byte count
        "data": b"",
        "comp_tag": 1,
        "n_entries": 11 + (1 if spp == 4 else 0),
        "extra_len": (2 * spp * 2) if spp * 2 > 4 else 0,
    }
    plan["ifd_size"] = 2 + plan["n_entries"] * 12 + 4
    seg = bytearray(_emit_page(plan, 8, 0))
    (count,) = struct.unpack("<H", seg[0:2])
    for i in range(count):  # patch STRIP_BYTE_COUNTS (emitted as 0)
        off = 2 + i * 12
        (tag,) = struct.unpack("<H", seg[off : off + 2])
        if tag == _STRIP_BYTE_COUNTS:
            seg[off + 8 : off + 12] = struct.pack("<I", nbytes)
    data_off = 8 + plan["ifd_size"] + plan["extra_len"]
    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, 8) + bytes(seg))
        f.truncate(data_off + nbytes)
    return np.memmap(path, dtype=dt, mode="r+", offset=data_off, shape=shape)


def _decode_packbits(data: bytes, expected: int) -> bytes:
    """Apple PackBits decompression."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i : i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i : i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _decode_lzw(data: bytes, expected: int) -> bytes:
    """TIFF-variant LZW (MSB-first, early code-size change; counterpart
    of ref lib/tifffile.c:658)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: list[bytes] = []

    def reset():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset()
    bitpos = 0
    nbits = 9
    prev: bytes | None = None
    total_bits = len(data) * 8
    while bitpos + nbits <= total_bits and len(out) < expected:
        byte0 = bitpos >> 3
        chunk = int.from_bytes(data[byte0 : byte0 + 4].ljust(4, b"\0"), "big")
        code = (chunk >> (32 - (bitpos & 7) - nbits)) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == EOI:
            break
        if code == CLEAR:
            reset()
            nbits = 9
            prev = None
            continue
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # TIFF "early change" (libtiff convention, validated against its
        # streams): widen after the table holds 2^nbits - 1 entries.
        if len(table) + 1 >= (1 << nbits) and nbits < 12:
            nbits += 1
    return bytes(out)


def _undo_predictor(rows: np.ndarray) -> np.ndarray:
    np.cumsum(rows, axis=1, dtype=rows.dtype, out=rows)
    return rows


_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_COLOR_MAP = 320
_CZ_LSMINFO = 34412  # Zeiss LSM private tag (first IFD only)

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
              10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 16: "Q", 8: "h", 9: "i", 17: "q"}


def _parse_ifd(raw: bytes, en: str, ifd_off: int, big: bool):
    """Parse one IFD into ({tag: (type, count, payload)}, next_ifd_offset);
    classic or BigTIFF.  ``next_ifd_offset`` is 0 on the last IFD of the
    chain (the reference walks the same chain via ``TiffPages``, ref
    lib/tifffile.py:2618)."""
    tags: dict[int, tuple[int, int, bytes]] = {}
    if big:
        (count,) = struct.unpack(en + "Q", raw[ifd_off : ifd_off + 8])
        base, entry, inline = ifd_off + 8, 20, 8
    else:
        (count,) = struct.unpack(en + "H", raw[ifd_off : ifd_off + 2])
        base, entry, inline = ifd_off + 2, 12, 4
    for idx in range(count):
        off = base + idx * entry
        if big:
            tag, typ, n = struct.unpack(en + "HHQ", raw[off : off + 12])
            vfield = raw[off + 12 : off + 20]
        else:
            tag, typ, n = struct.unpack(en + "HHI", raw[off : off + 8])
            vfield = raw[off + 8 : off + 12]
        size = _TYPE_SIZE.get(typ, 1) * n
        if size <= inline:
            payload = vfield[:size]
        else:
            (ptr,) = struct.unpack(en + ("Q" if big else "I"), vfield)
            payload = raw[ptr : ptr + size]
        tags[tag] = (typ, n, payload)
    next_off_pos = base + count * entry
    (next_off,) = struct.unpack(
        en + ("Q" if big else "I"),
        raw[next_off_pos : next_off_pos + (8 if big else 4)],
    )
    return tags, next_off


def _decode_segment(seg: bytes, expected: int, compression: int) -> bytes:
    if compression == 1:
        return seg[:expected]
    if compression == 32773:
        return _decode_packbits(seg, expected)
    if compression == 5:
        return _decode_lzw(seg, expected)
    if compression in (8, 32946):
        # 8 = Adobe Deflate, 32946 = legacy Deflate — both plain zlib
        # streams (ref lib/tifffile.py:4988-5007 tag values, :5245 decoder)
        import zlib

        return zlib.decompress(seg)[:expected]
    if compression == 34925:
        # LZMA2 segments (ref lib/tifffile.py:5250 — stdlib lzma, gated
        # on availability there; unconditional here)
        import lzma

        return lzma.decompress(seg)[:expected]
    raise NotImplementedError(f"TIFF compression {compression}")


def imread(path: str, memmap: bool = False, pages: bool = False):
    """Read a TIFF: classic or BigTIFF, strip or tile layout,
    uncompressed / PackBits / LZW / Deflate / LZMA / new-style JPEG (7),
    8/16-bit unsigned, 8/16-bit signed or 32/64-bit float samples,
    either byte order.

    ``pages=True`` walks the whole IFD chain (the reference's ``TiffPages``,
    ref lib/tifffile.py:2618) and returns an (N, ...) stack when the pages
    share shape and dtype, else a list of arrays.  The default reads the
    first page only, warning if more exist.

    ``memmap=True`` returns a read-only ``np.memmap`` view of the pixel
    data without loading it (the analog of the reference's
    ``tifffile.memmap``, ref lib/tifffile.py:479); requires an uncompressed
    strip layout with contiguous strips (first page only).
    """
    import mmap as _mmap

    f = open(path, "rb")
    try:
        # memory-map instead of read(): header/IFD parsing touches a few
        # pages, so imread(memmap=True) never loads the pixel payload (the
        # zero-copy contract); the normal path faults pages in on demand.
        raw = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
    except (ValueError, OSError):  # zero-length or unmappable file
        raw = f.read()
        f.close()
    else:
        f.close()
    return _decode_tiff(raw, path, memmap=memmap, pages=pages)


def _decode_tiff(raw, path: str, memmap: bool = False, pages: bool = False):
    """Decode a TIFF from an in-memory buffer (bytes or mmap); see imread."""
    byte_order = raw[:2]
    if byte_order == b"II":
        en = "<"
    elif byte_order == b"MM":
        en = ">"
    else:
        raise ValueError("not a TIFF file")
    (magic,) = struct.unpack(en + "H", raw[2:4])
    if magic == 42:  # classic
        big = False
        (ifd_off,) = struct.unpack(en + "I", raw[4:8])
    elif magic == 43:  # BigTIFF
        big = True
        osize, zero, ifd_off = struct.unpack(en + "HHQ", raw[4:16])
        if osize != 8 or zero != 0:
            raise ValueError("malformed BigTIFF header")
    else:
        raise ValueError("not a TIFF file")

    if not pages:
        tags, next_off = _parse_ifd(raw, en, ifd_off, big)
        if next_off:
            import warnings

            warnings.warn(
                f"{path!r} is a multi-page TIFF; imread returns the first "
                "page (pass pages=True for the whole chain)",
                stacklevel=2,
            )
        return _read_page(raw, en, big, tags, path, memmap)

    if memmap:
        raise ValueError("memmap=True reads a single page; drop pages=True")
    out_pages = []
    page_tags = []
    first_tags = None
    seen = set()
    while ifd_off and ifd_off not in seen:  # cycle guard on corrupt chains
        seen.add(ifd_off)
        tags, ifd_off = _parse_ifd(raw, en, ifd_off, big)
        if first_tags is None:
            first_tags = tags
        page_tags.append(tags)
        out_pages.append(_read_page(raw, en, big, tags, path, False))
    if first_tags is not None and _CZ_LSMINFO in first_tags:
        lsm = _lsm_stack(en, first_tags, page_tags, out_pages)
        if lsm is not None:
            return lsm
    if len(out_pages) == 1:
        # ImageJ writes hyperstacks as ONE IFD + "images=N" in the
        # ImageDescription, with the N frames contiguous after the first
        # (the reference reads them via its is_imagej / contiguous-series
        # path, ref lib/tifffile.py TiffPage.is_imagej handling)
        stack = _imagej_contiguous_stack(raw, en, first_tags, out_pages[0])
        if stack is not None:
            return stack
    if len({(p.shape, p.dtype) for p in out_pages}) == 1:
        stack = np.stack(out_pages)
        # OME-TIFF: the first page's ImageDescription is OME-XML whose
        # Pixels element orders the plane chain (the reference's
        # tifffile reads these as its ome series) — normalize to
        # (T, Z, C, Y, X[, S])
        shaped = _ome_reshape(first_tags, stack)
        return stack if shaped is None else shaped
    return out_pages


def _ome_reshape(tags, stack: np.ndarray):
    """Reshape an (N, ...) page stack to (T, Z, C, Y, X[, S]) per the
    OME-XML Pixels element in the first page's ImageDescription; None when
    this isn't an OME-TIFF or the plane count doesn't match."""
    desc_tag = tags.get(_IMAGE_DESCRIPTION)
    if desc_tag is None or desc_tag[0] != 2:
        return None
    desc = desc_tag[2].split(b"\0", 1)[0].decode("utf-8", "replace").strip()
    if not desc.startswith("<?xml") and "<OME" not in desc[:200]:
        return None
    try:
        import xml.etree.ElementTree as ET

        root = ET.fromstring(desc)
    except ET.ParseError:
        return None
    pixels = next(
        (el for el in root.iter() if el.tag.rsplit("}", 1)[-1] == "Pixels"),
        None,
    )
    if pixels is None:
        return None
    try:
        sizes = {d: int(pixels.get(f"Size{d}", "1")) for d in "CZT"}
        order = pixels.get("DimensionOrder", "XYZCT")
    except (TypeError, ValueError):
        return None
    rem = [d for d in order[2:] if d in "CZT"]
    if sorted(rem) != ["C", "T", "Z"]:
        return None
    n_planes = sizes["C"] * sizes["Z"] * sizes["T"]
    if n_planes != stack.shape[0]:
        return None  # multi-file OME or TiffData gaps: leave the raw stack
    # plane index runs FASTEST along the first letter after XY, so the
    # reshape axes are reversed(rem); then permute to canonical (T, Z, C)
    shaped = stack.reshape(
        tuple(sizes[d] for d in reversed(rem)) + stack.shape[1:]
    )
    axes = [list(reversed(rem)).index(d) for d in "TZC"]
    return np.transpose(
        shaped, tuple(axes) + tuple(range(3, shaped.ndim))
    )


def _lsm_stack(en: str, first_tags, page_tags, pages):
    """Zeiss LSM: drop the interleaved thumbnail IFDs (NewSubfileType bit
    0x1 = reduced-resolution) and, when the CZ_LSMINFO dimensions match,
    shape the full-resolution planes to (T, Z, Y, X[, S]) — Z runs fastest
    along the LSM plane chain (the reference's tifffile reads these via
    its lsm series path).  None when the full-res pages are inhomogeneous
    (caller falls back to the generic stack/list handling)."""
    full = [
        p
        for t, p in zip(page_tags, pages)
        if not (
            _NEW_SUBFILE_TYPE in t
            and struct.unpack(
                en + _TYPE_FMT[t[_NEW_SUBFILE_TYPE][0]],
                t[_NEW_SUBFILE_TYPE][2][
                    : _TYPE_SIZE[t[_NEW_SUBFILE_TYPE][0]]
                ],
            )[0]
            & 0x1
        )
    ]
    if not full or len({(p.shape, p.dtype) for p in full}) != 1:
        return None
    stack = np.stack(full)
    info = first_tags[_CZ_LSMINFO][2]
    if len(info) >= 28:
        # CZ_LSMINFO layout: u32 magic, i32 size, i32 DimX, DimY, DimZ,
        # DimChannels, DimTime (channels ride SamplesPerPixel here)
        dim_z, _dim_c, dim_t = struct.unpack(en + "3i", info[16:28])
        if dim_z >= 1 and dim_t >= 1 and dim_z * dim_t == stack.shape[0]:
            return stack.reshape((dim_t, dim_z) + stack.shape[1:])
    return stack


def _imagej_contiguous_stack(raw, en: str, tags, first_page: np.ndarray):
    """Return the (N, ...) frame stack of an ImageJ contiguous file, or
    None when this page isn't one (not ImageJ, images<=1, compressed, or
    the file is too short for the advertised frame count)."""
    desc_tag = tags.get(_IMAGE_DESCRIPTION)
    if desc_tag is None or desc_tag[0] != 2:  # type 2 = ASCII
        return None
    desc = desc_tag[2].split(b"\0", 1)[0].decode("latin-1", "replace")
    if not desc.startswith("ImageJ="):
        return None
    n_images = 1
    for line in desc.split("\n"):
        if line.startswith("images="):
            try:
                n_images = int(line[len("images="):].strip())
            except ValueError:
                return None
    if n_images <= 1:
        return None

    def values(tag):
        if tag not in tags:
            return None
        typ, n, payload = tags[tag]
        return list(struct.unpack(en + _TYPE_FMT[typ] * n, payload))

    compression = (values(_COMPRESSION) or [1])[0]
    predictor = (values(_PREDICTOR) or [1])[0]
    offsets = values(_STRIP_OFFSETS)
    if compression != 1 or predictor != 1 or not offsets or _TILE_OFFSETS in tags:
        return None
    frame_bytes = first_page.nbytes
    start, end = offsets[0], offsets[0] + n_images * frame_bytes
    if end > len(raw):
        return None  # truncated file: fall back to the single decoded page
    flat = np.frombuffer(raw[start:end], dtype=first_page.dtype.newbyteorder(en))
    stack = flat.reshape((n_images,) + first_page.shape)
    return stack.astype(first_page.dtype, copy=False)


# TIFF SampleFormat (tag 339) x BitsPerSample -> numpy dtype.  1 = unsigned
# int, 2 = signed int, 3 = IEEE float (the reference reads all of these via
# its dtype table, ref lib/tifffile.py:479 memmap / TiffPage dtype logic).
_SAMPLE_DTYPES = {
    (1, 8): "u1", (1, 16): "u2",
    (2, 8): "i1", (2, 16): "i2",
    (3, 32): "f4", (3, 64): "f8",
}


_YCBCR_COEFFICIENTS = 529
_YCBCR_SUBSAMPLING = 530
_REFERENCE_BLACK_WHITE = 532
_JPEG_TABLES = 347
_FILL_ORDER = 266

# byte-wise bit reversal for FillOrder=2 (TIFF 6.0 §4: lsb-first files;
# reversing each byte reduces both orders to the msb-first unpack below)
_BITREV = np.array(
    [int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8
)


def _read_subbyte_page(raw, tags, values, width, height, bps,
                       compression, predictor, photometric):
    """1/2/4-bit sample reads (bilevel, low-depth grayscale, 4-bit
    palette) — the reference's C codec unpacks these in
    ``py_unpackints`` (ref lib/tifffile.c:432); here rows unpack with
    numpy shifts.  Each row is padded to a byte boundary (TIFF 6.0 §3);
    strip layout only.  Returns uint8 index/gray values (palette files
    expand through ColorMap at the call site); WhiteIsZero (photometric
    0) returns raw values like the reference stack — inversion is the
    caller's display decision."""
    if predictor != 1:
        raise NotImplementedError("sub-byte samples with predictor")
    if _TILE_OFFSETS in tags:
        raise NotImplementedError("sub-byte tiled TIFF")
    fillorder = values(_FILL_ORDER, [1])[0]
    rows_per_strip = values(_ROWS_PER_STRIP, [height])[0]
    offsets = values(_STRIP_OFFSETS)
    counts = values(_STRIP_BYTE_COUNTS)
    row_bytes = -(-width * bps // 8)
    out = np.empty((height, width), np.uint8)
    row = 0
    for off, cnt in zip(offsets, counts):
        nrows = min(rows_per_strip, height - row)
        decoded = _decode_segment(
            raw[off : off + cnt], nrows * row_bytes, compression
        )
        b = np.frombuffer(decoded, np.uint8)[: nrows * row_bytes]
        b = b.reshape(nrows, row_bytes)
        if fillorder == 2:
            b = _BITREV[b]
        if bps == 1:
            vals = np.unpackbits(b, axis=1)[:, :width]
        elif bps == 4:
            vals = np.empty((nrows, row_bytes * 2), np.uint8)
            vals[:, 0::2] = b >> 4
            vals[:, 1::2] = b & 0x0F
            vals = vals[:, :width]
        else:  # bps == 2
            vals = np.empty((nrows, row_bytes * 4), np.uint8)
            for k, sh in enumerate((6, 4, 2, 0)):
                vals[:, k::4] = (b >> sh) & 0x03
            vals = vals[:, :width]
        out[row : row + nrows] = vals
        row += nrows
    return out


def _read_jpeg_page(raw, tags, values, width, height, spp, photometric):
    """JPEG-in-TIFF reads, compression 7 (TIFF TechNote 2 "new-style"
    JPEG; the vendored reference stack decodes these through its codec
    table, ref lib/tifffile.py COMPRESSION.JPEG).  Each strip/tile is an
    (optionally abbreviated) JPEG stream; shared quantization/Huffman
    tables live in the JPEGTables tag (347) as a tables-only stream
    (SOI..EOI).  Decoding delegates to PIL's libjpeg: a tables stream is
    spliced ahead of each segment (tables[:-2] EOI dropped + segment SOI
    skipped — duplicate in-segment tables legally override).  Output is
    what libjpeg yields: RGB for 3-component streams (the photometric-6
    YCbCr→RGB conversion happens inside the codec, matching the
    reference stack's JPEG path), L for 1-component."""
    import io as _io

    from PIL import Image

    tables = b""
    if _JPEG_TABLES in tags:
        t = bytes(tags[_JPEG_TABLES][2])  # payload is dereferenced bytes
        if len(t) > 4 and t[:2] == b"\xff\xd8":  # valid stream: SOI..EOI
            tables = t

    def decode(seg: bytes) -> np.ndarray:
        if tables and seg[:2] == b"\xff\xd8":
            seg = tables[:-2] + seg[2:]
        with Image.open(_io.BytesIO(seg)) as im:
            return np.asarray(im)

    out = np.zeros(
        (height, width, spp) if spp > 1 else (height, width), np.uint8
    )
    if _TILE_OFFSETS in tags:
        tw = values(_TILE_WIDTH)[0]
        tl = values(_TILE_LENGTH)[0]
        offsets = values(_TILE_OFFSETS)
        counts = values(_TILE_BYTE_COUNTS)
        tiles_across = -(-width // tw)
        for i, (off, cnt) in enumerate(zip(offsets, counts)):
            ty, tx = divmod(i, tiles_across)
            px = decode(bytes(raw[off : off + cnt]))
            y0, x0 = ty * tl, tx * tw
            vy = min(tl, height - y0)
            vx = min(tw, width - x0)
            out[y0 : y0 + vy, x0 : x0 + vx] = px[:vy, :vx]
    else:
        rows_per_strip = values(_ROWS_PER_STRIP, [height])[0]
        offsets = values(_STRIP_OFFSETS)
        counts = values(_STRIP_BYTE_COUNTS)
        row = 0
        for off, cnt in zip(offsets, counts):
            nrows = min(rows_per_strip, height - row)
            px = decode(bytes(raw[off : off + cnt]))
            out[row : row + nrows] = px[:nrows, :width]
            row += nrows
    return out


def _read_ycbcr_page(raw, tags, values, rationals, width, height, bps,
                     compression, predictor, planar):
    """Raw (non-JPEG) YCbCr reads, photometric 6 (TIFF 6.0 §21; the
    vendored reference stack reads these via its photometric table, ref
    lib/tifffile.py PHOTOMETRIC.YCBCR handling).

    Chunky strips only; samples are stored in data units of h*v Y values
    (row-major within the unit) followed by one Cb and one Cr, with the
    frame padded up to whole units.  Chroma is upsampled by replication
    (positioning/cosited interpolation intentionally ignored — replication
    is what the reference stack and libtiff's fast path do), headroom is
    removed per ReferenceBlackWhite (libtiff's YCbCr default
    [0,255,128,255,128,255]), and RGB comes from the YCbCrCoefficients
    (default ITU-R 601: 0.299/0.587/0.114).  Returns uint8 RGB."""
    if planar != 1:
        raise NotImplementedError("planar (separate-plane) YCbCr TIFF")
    if _TILE_OFFSETS in tags:
        raise NotImplementedError("tiled YCbCr TIFF")
    if predictor != 1:
        raise NotImplementedError("predictor on YCbCr TIFF")
    if bps != 8:
        raise NotImplementedError(f"{bps}-bit YCbCr TIFF")
    h_ss, v_ss = values(_YCBCR_SUBSAMPLING, [2, 2])[:2]
    if (h_ss, v_ss) not in ((1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)):
        raise NotImplementedError(f"YCbCr subsampling {(h_ss, v_ss)}")
    lr, lg, lb = rationals(_YCBCR_COEFFICIENTS, [0.299, 0.587, 0.114])
    ref = rationals(_REFERENCE_BLACK_WHITE,
                    [0.0, 255.0, 128.0, 255.0, 128.0, 255.0])

    units_across = -(-width // h_ss)
    pad_w = units_across * h_ss
    rows_per_strip = values(_ROWS_PER_STRIP, [height])[0]
    offsets = values(_STRIP_OFFSETS)
    counts = values(_STRIP_BYTE_COUNTS)

    y_full = np.empty((height, width), np.float32)
    cb_full = np.empty((height, width), np.float32)
    cr_full = np.empty((height, width), np.float32)
    row = 0
    for off, cnt in zip(offsets, counts):
        nrows = min(rows_per_strip, height - row)
        unit_rows = -(-nrows // v_ss)
        expected = unit_rows * units_across * (h_ss * v_ss + 2)
        decoded = _decode_segment(raw[off : off + cnt], expected, compression)
        units = np.frombuffer(decoded, np.uint8).reshape(
            unit_rows, units_across, h_ss * v_ss + 2
        )
        y = (
            units[:, :, : h_ss * v_ss]
            .reshape(unit_rows, units_across, v_ss, h_ss)
            .transpose(0, 2, 1, 3)
            .reshape(unit_rows * v_ss, pad_w)
        )
        cb = np.repeat(np.repeat(units[:, :, h_ss * v_ss], h_ss, axis=1),
                       v_ss, axis=0)
        cr = np.repeat(np.repeat(units[:, :, h_ss * v_ss + 1], h_ss, axis=1),
                       v_ss, axis=0)
        y_full[row : row + nrows] = y[:nrows, :width]
        cb_full[row : row + nrows] = cb[:nrows, :width]
        cr_full[row : row + nrows] = cr[:nrows, :width]
        row += nrows

    # headroom removal (TIFF 6.0 §20): luma expands to 0..255, chroma to
    # a signed value centered on its reference black (coding range 127)
    y_full = (y_full - ref[0]) * (255.0 / (ref[1] - ref[0] or 1.0))
    cb_full = (cb_full - ref[2]) * (127.0 / (ref[3] - ref[2] or 1.0))
    cr_full = (cr_full - ref[4]) * (127.0 / (ref[5] - ref[4] or 1.0))
    r = cr_full * (2.0 - 2.0 * lr) + y_full
    b = cb_full * (2.0 - 2.0 * lb) + y_full
    g = (y_full - lr * r - lb * b) / (lg or 1.0)
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.rint(rgb), 0.0, 255.0).astype(np.uint8)


def _read_page(raw, en: str, big: bool, tags, path: str, memmap: bool):
    def values(tag, default=None):
        if tag not in tags:
            return default
        typ, n, payload = tags[tag]
        fmt = _TYPE_FMT[typ]
        return list(struct.unpack(en + fmt * n, payload))

    width = values(_IMAGE_WIDTH)[0]
    height = values(_IMAGE_LENGTH)[0]
    spp = values(_SAMPLES_PER_PIXEL, [1])[0]
    bps = values(_BITS_PER_SAMPLE, [1])[0]
    compression = values(_COMPRESSION, [1])[0]
    predictor = values(_PREDICTOR, [1])[0]
    planar = values(_PLANAR_CONFIG, [1])[0]
    photometric = values(_PHOTOMETRIC, [1])[0]
    if planar not in (1, 2):
        raise NotImplementedError(f"TIFF planar configuration {planar}")
    if predictor not in (1, 2):
        # e.g. 3 = floating-point differencing; silently skipping it would
        # return garbage pixels
        raise NotImplementedError(f"TIFF predictor {predictor} not supported")
    sample_format = values(_SAMPLE_FORMAT, [1])[0]
    code = _SAMPLE_DTYPES.get((sample_format, bps))
    if code is None:
        if (sample_format == 1 and bps in (1, 2, 4) and planar == 1
                and spp == 1):
            if memmap:
                raise ValueError("memmap unsupported for sub-byte samples")
            arr = _read_subbyte_page(raw, tags, values, width, height,
                                     bps, compression, predictor,
                                     photometric)
            if photometric == 3:
                cmap = values(_COLOR_MAP)
                if cmap is None:
                    raise ValueError(
                        "palette TIFF (photometric 3) without ColorMap"
                    )
                cm = np.asarray(cmap, np.uint16).reshape(3, 1 << bps)
                return np.stack(
                    [cm[0][arr], cm[1][arr], cm[2][arr]], axis=-1
                )
            return arr
        raise NotImplementedError(
            f"TIFF sample format {sample_format} at {bps} bits not supported"
        )
    dtype = np.dtype(en + code)

    if memmap:
        if (_TILE_OFFSETS in tags or compression != 1 or predictor != 1
                or planar != 1 or photometric in (3, 6)):
            raise ValueError(
                "memmap requires an uncompressed, unpredicted, chunky "
                "(PlanarConfiguration=1) strip layout"
            )
        native = {"little": "<", "big": ">"}[sys.byteorder]
        if dtype.itemsize > 1 and dtype.byteorder not in ("=", "|", native):
            # byteswapping needs a copy, which defeats the zero-copy
            # contract — the normal imread path returns native order
            raise ValueError(
                "memmap requires native byte order; this TIFF is "
                "opposite-endian — use imread(memmap=False)"
            )
        offsets = values(_STRIP_OFFSETS)
        counts = values(_STRIP_BYTE_COUNTS)
        for o, c_, prev_o, prev_c in zip(
            offsets[1:], counts[1:], offsets, counts
        ):
            if o != prev_o + prev_c:
                raise ValueError("memmap requires contiguous strips")
        shape = (height, width, spp) if spp > 1 else (height, width)
        return np.memmap(
            path, dtype=dtype, mode="r", offset=offsets[0], shape=shape
        )

    if compression == 7:
        if planar != 1:
            raise NotImplementedError("planar JPEG-compressed TIFF")
        return _read_jpeg_page(raw, tags, values, width, height, spp,
                               photometric)
    if compression == 6:
        raise NotImplementedError(
            "old-style JPEG (compression 6) TIFF — deprecated by TIFF "
            "TechNote 2; re-save with new-style JPEG (7)"
        )

    if photometric == 6:
        def rationals(tag, default):
            if tag not in tags:
                return default
            typ, n, payload = tags[tag]
            if typ != 5:
                return [float(v) for v in values(tag)]
            flat = struct.unpack(en + "I" * (2 * n), payload)
            return [
                flat[2 * i] / (flat[2 * i + 1] or 1) for i in range(n)
            ]

        return _read_ycbcr_page(raw, tags, values, rationals,
                                width, height, bps, compression,
                                predictor, planar)

    def apply_palette(arr):
        """Palette-color (TIFF 6.0 §5): pixels are indices into the 16-bit
        ColorMap (3 x 2^bps entries, all R then all G then all B — ref
        lib/tifffile.py COLORMAP handling).  Returns RGB uint16, the
        reference stack's apply-colormap semantics."""
        cmap = values(_COLOR_MAP)
        if cmap is None:
            raise ValueError("palette TIFF (photometric 3) without ColorMap")
        idx = arr if arr.ndim == 2 else arr[..., 0]
        cm = np.asarray(cmap, np.uint16).reshape(3, 1 << bps)
        return np.stack([cm[0][idx], cm[1][idx], cm[2][idx]], axis=-1)

    if planar == 2:
        # PlanarConfiguration=2 (TIFF 6.0 §14): each sample's rows are
        # stored in their own strip series — all of sample 0's strips,
        # then sample 1's, ... (ref lib/tifffile.py's planarconfig
        # SEPARATE path).  Horizontal differencing applies per plane.
        if _TILE_OFFSETS in tags:
            raise NotImplementedError("planar tiled TIFF not supported")
        rows_per_strip = values(_ROWS_PER_STRIP, [height])[0]
        offsets = values(_STRIP_OFFSETS)
        counts = values(_STRIP_BYTE_COUNTS)
        strips_per_plane = -(-height // rows_per_strip)
        if len(offsets) != strips_per_plane * spp:
            raise ValueError(
                "planar TIFF strip count %d != %d planes x %d strips"
                % (len(offsets), spp, strips_per_plane)
            )
        row_bytes = width * (bps // 8)
        planes = np.empty((spp, height, width), dtype=dtype)
        for s in range(spp):
            row = 0
            for k in range(strips_per_plane):
                off = offsets[s * strips_per_plane + k]
                cnt = counts[s * strips_per_plane + k]
                nrows = min(rows_per_strip, height - row)
                decoded = _decode_segment(
                    raw[off : off + cnt], nrows * row_bytes, compression
                )
                rows = np.frombuffer(decoded, dtype=dtype).reshape(
                    nrows, width
                )
                if predictor == 2:
                    rows = _undo_predictor(
                        rows.reshape(nrows, width, 1).astype(dtype).copy()
                    ).reshape(nrows, width)
                planes[s, row : row + nrows] = rows
                row += nrows
        arr = np.moveaxis(planes, 0, -1) if spp > 1 else planes[0]
        if photometric == 3:
            return apply_palette(arr)
        return np.ascontiguousarray(
            arr.astype(dtype.newbyteorder("="), copy=False)
        )

    out = np.empty((height, width * spp), dtype=dtype)

    def undo_pred(rows, nrows, ncols):
        if predictor == 2:
            rows = _undo_predictor(
                rows.reshape(nrows, ncols, spp).astype(dtype).copy()
            ).reshape(nrows, ncols * spp)
        return rows

    if _TILE_OFFSETS in tags:
        tw = values(_TILE_WIDTH)[0]
        tl = values(_TILE_LENGTH)[0]
        offsets = values(_TILE_OFFSETS)
        counts = values(_TILE_BYTE_COUNTS)
        tiles_across = -(-width // tw)
        tile_bytes = tl * tw * spp * (bps // 8)
        for i, (off, cnt) in enumerate(zip(offsets, counts)):
            ty, tx = divmod(i, tiles_across)
            decoded = _decode_segment(raw[off : off + cnt], tile_bytes, compression)
            rows = np.frombuffer(decoded, dtype=dtype).reshape(tl, tw * spp)
            rows = undo_pred(rows, tl, tw)
            y0, x0 = ty * tl, tx * tw
            vy = min(tl, height - y0)
            vx = min(tw, width - x0)
            out[y0 : y0 + vy, x0 * spp : (x0 + vx) * spp] = rows[
                :vy, : vx * spp
            ]
    else:
        rows_per_strip = values(_ROWS_PER_STRIP, [height])[0]
        offsets = values(_STRIP_OFFSETS)
        counts = values(_STRIP_BYTE_COUNTS)
        row_bytes = width * spp * (bps // 8)
        row = 0
        for off, cnt in zip(offsets, counts):
            nrows = min(rows_per_strip, height - row)
            decoded = _decode_segment(
                raw[off : off + cnt], nrows * row_bytes, compression
            )
            rows = np.frombuffer(decoded, dtype=dtype).reshape(nrows, width * spp)
            rows = undo_pred(rows, nrows, width)
            out[row : row + nrows] = rows
            row += nrows

    arr = out.reshape(height, width, spp) if spp > 1 else out.reshape(height, width)
    if photometric == 3:
        return apply_palette(arr)
    # copy=False: skip the redundant 144 MB copy for the common
    # native-order case (only opposite-endian files pay the byteswap)
    return arr.astype(dtype.newbyteorder("="), copy=False)


def read_description(path: str) -> str | None:
    """The first page's ImageDescription (where ImageJ / OME-XML metadata
    live), or None — the lightweight counterpart of the reference's
    tifffile page ``description`` attribute.  mmap-backed: only the
    header/IFD pages fault in; pixel data is never read."""
    import mmap as _mmap

    with open(path, "rb") as f:
        try:
            raw = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        except (ValueError, OSError):
            raw = f.read()
    en = {b"II": "<", b"MM": ">"}.get(bytes(raw[:2]))
    if en is None:
        raise ValueError("not a TIFF file")
    (magic,) = struct.unpack(en + "H", raw[2:4])
    if magic == 42:
        (ifd_off,) = struct.unpack(en + "I", raw[4:8])
        big = False
    elif magic == 43:
        (ifd_off,) = struct.unpack(en + "Q", raw[8:16])
        big = True
    else:
        raise ValueError("not a TIFF file")
    tags, _ = _parse_ifd(raw, en, ifd_off, big)
    desc = tags.get(_IMAGE_DESCRIPTION)
    if desc is None or desc[0] != 2:
        return None
    return desc[2].split(b"\0", 1)[0].decode("utf-8", "replace")


def imread_sequence(pattern, prefetch: bool = True) -> np.ndarray:
    """Read a glob (or an explicit path list) of same-shaped TIFFs as one
    (N, ...) stack — the analog of the reference's ``TiffSequence``
    (ref lib/tifffile.py:4073).

    Files are read one after another; ``prefetch`` is accepted for the JAX
    package's signature (its native prefetcher is not ported)."""
    if isinstance(pattern, str):
        import glob

        paths = sorted(glob.glob(pattern))
    else:
        paths = [os.fspath(p) for p in pattern]
    if not paths:
        raise FileNotFoundError(f"no files match {pattern!r}")

    return np.stack([imread(p) for p in paths])


def load_image(path: str) -> np.ndarray:
    """Load JPEG/PNG via PIL or TIFF via our reader, as a numpy array."""
    lower = path.lower()
    if lower.endswith((".tif", ".tiff")):
        return imread(path)
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img)
