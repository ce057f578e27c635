"""The port's native runtime (``ics_tpu_torch.runtime``): the C++ LZW and
PackBits coders against the port's pure-Python coders and the JAX
package's, the thread-pool loader against direct reads, and the build
(first use, a compile error raises, only a missing compiler turns it off).
Skips only on a host without a C++ compiler."""

import os

import numpy as np
import pytest

from ics_tpu.runtime import codecs as jax_codecs
from ics_tpu.utils import io as jio

from ics_tpu_torch.runtime import _lib, codecs, loader
from ics_tpu_torch.utils import io

RNG = np.random.default_rng(61)


@pytest.fixture(scope="module", autouse=True)
def native():
    if _lib.compiler() is None:
        pytest.skip("no C++ compiler on this host")
    assert codecs.available() and loader.available()


def _buffer(kind: str, n: int = 20000) -> bytes:
    if kind == "random":
        return RNG.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "runs":  # long runs, short runs and literals
        return np.repeat(RNG.integers(0, 4, n // 16, dtype=np.uint8),
                         RNG.integers(1, 40, n // 16)).tobytes()
    if kind == "text":
        return b"TOBEORNOTTOBEORTOBEORNOT" * (n // 24)
    if kind == "image":  # a smooth 16-bit RGB frame, as the TIFF writer sees it
        x = np.cumsum(RNG.integers(-3, 4, (40, 60, 3)), axis=1) + 30000
        return x.astype("<u2").tobytes()
    return b"\x00" * n  # "zeros": the longest runs and the widest LZW table


KINDS = ["random", "runs", "text", "image", "zeros"]


def _jax(name: str):
    """The JAX package's native coder where its library is built, else its
    Python coder (the same bytes)."""
    native = jax_codecs.available() and jax_codecs.has_encoders()
    return {
        "encode_lzw": jax_codecs.encode_lzw if native else jio._encode_lzw_py,
        "encode_packbits": jax_codecs.encode_packbits if native else jio._encode_packbits_py,
    }[name]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("coder", ["lzw", "packbits"])
def test_native_encoder_bytes(coder, kind):
    data = _buffer(kind)
    native = getattr(codecs, f"encode_{coder}")(data)
    assert native == getattr(io, f"_encode_{coder}_py")(data)
    assert native == _jax(f"encode_{coder}")(data)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("coder", ["lzw", "packbits"])
def test_native_decoder_round_trip(coder, kind):
    data = _buffer(kind)
    encoded = getattr(io, f"_encode_{coder}_py")(data)
    assert getattr(codecs, f"decode_{coder}")(encoded, len(data)) == data
    # a bytearray, as a prefetched file's segments are, decodes in place
    assert getattr(codecs, f"decode_{coder}")(bytearray(encoded), len(data)) == data
    assert getattr(io, f"_decode_{coder}_py")(encoded, len(data)) == data
    assert getattr(io, f"_decode_{coder}")(encoded, len(data)) == data  # the native route


@pytest.mark.parametrize("compression", ["lzw", "packbits"])
def test_tiff_writer_uses_native_coders(compression, tmp_path):
    """imsave's strips through the native coders read back, and equal the
    JAX package's file byte for byte."""
    arr = (np.cumsum(RNG.integers(-40, 41, (30, 50, 3)), axis=1) + 30000).astype(np.uint16)
    io.imsave(str(tmp_path / "port.tif"), arr, compression=compression)
    jio.imsave(str(tmp_path / "jax.tif"), arr, compression=compression)
    assert (tmp_path / "port.tif").read_bytes() == (tmp_path / "jax.tif").read_bytes()
    np.testing.assert_array_equal(io.imread(str(tmp_path / "port.tif")), arr)


def _files(tmp_path, n=6):
    files = []
    for i in range(n):
        payload = RNG.integers(0, 256, 1000 + 137 * i, dtype=np.uint8).tobytes()
        path = tmp_path / f"f{i}.bin"
        path.write_bytes(payload)
        files.append((str(path), payload))
    return files


@pytest.mark.parametrize("threads", [1, 3])
def test_prefetcher_matches_direct_reads(threads, tmp_path):
    files = _files(tmp_path)
    (tmp_path / "empty.bin").write_bytes(b"")
    files.append((str(tmp_path / "empty.bin"), b""))
    with loader.Prefetcher(n_threads=threads) as pool:
        tickets = [pool.submit(p) for p, _ in files]
        for ticket, (path, payload) in zip(tickets, files):
            got = pool.take(ticket)
            assert isinstance(got, bytearray) and len(got) == len(payload)
            assert got == payload == open(path, "rb").read()


def test_prefetcher_missing_file_raises(tmp_path):
    with loader.Prefetcher(n_threads=2) as pool:
        good = pool.submit(_files(tmp_path, 1)[0][0])
        bad = pool.submit(str(tmp_path / "missing.bin"))
        with pytest.raises(OSError):
            pool.take(bad)
        assert pool.take(good) == open(tmp_path / "f0.bin", "rb").read()


@pytest.mark.parametrize("compression", [None, "lzw", "packbits", "deflate"])
@pytest.mark.parametrize("dtype,channels", [(np.uint16, 3), (np.uint8, 1)])
def test_imread_sequence_prefetch_matches_serial_and_jax(dtype, channels, compression,
                                                         tmp_path):
    """The prefetcher's in-memory files decode as the mapped ones do, each
    compression's segments read through a view of the buffer."""
    top = np.iinfo(dtype).max
    for i in range(4):
        arr = (RNG.random((10, 12, channels)) * top).astype(dtype)
        io.imsave(str(tmp_path / f"s{i:02d}.tif"), arr[..., 0] if channels == 1 else arr,
                  compression=compression)
    pattern = str(tmp_path / "s*.tif")
    fast = io.imread_sequence(pattern, prefetch=True)
    slow = io.imread_sequence(pattern, prefetch=False)
    assert fast.shape[0] == 4 and fast.dtype == dtype
    np.testing.assert_array_equal(fast, slow)
    np.testing.assert_array_equal(fast, jio.imread_sequence(pattern, prefetch=True))


def test_compile_error_raises(tmp_path):
    """A source that does not compile raises with the compiler's output; it
    never falls back to the Python coders."""
    src = tmp_path / "src"
    src.mkdir()
    text = (_lib._SRC / "codecs.cpp").read_text()
    (src / "codecs.cpp").write_text(text.replace("extern \"C\" {", "extern \"C\" { int x = ;", 1))
    with pytest.raises(RuntimeError, match="C\\+\\+ compile failed:(.|\\n)*error"):
        _lib.build(src_dir=src, out_root=tmp_path / "build")
    assert not list((tmp_path / "build").rglob("*.so"))


def test_build_is_keyed_by_the_sources(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in ("codecs.cpp", "loader.cpp"):
        (src / name).write_text((_lib._SRC / name).read_text())
    first = _lib.build(src_dir=src, out_root=tmp_path / "build")
    assert _lib.build_seconds > 0  # compiled in this process
    assert _lib.build(src_dir=src, out_root=tmp_path / "build") == first  # cached
    (src / "loader.cpp").write_text((src / "loader.cpp").read_text() + "\n// edited\n")
    second = _lib.build(src_dir=src, out_root=tmp_path / "build")
    assert second != first and second.exists() and first.parent.parent == second.parent.parent


def test_only_a_missing_compiler_turns_the_runtime_off(monkeypatch):
    """No compiler: available() is False and the TIFF coders run in Python;
    the failure is not remembered, so the library is found once a compiler
    is there again."""
    monkeypatch.setattr(_lib, "_lib", None)
    monkeypatch.setenv("CXX", os.path.join(os.sep, "nonexistent", "c++"))
    assert _lib.compiler() is None
    assert not codecs.available() and not loader.available()
    data = _buffer("text")
    assert io._decode_lzw(io._encode_lzw_py(data), len(data)) == data
    with pytest.raises(RuntimeError, match="compiler"):
        loader.Prefetcher()
    monkeypatch.delenv("CXX")
    assert codecs.available() and loader.available()
