"""The port's TIFF I/O (a copy of ics_tpu/utils/io.py with its pure-Python
codecs) against ``ics_tpu.utils.io``: byte-identical files, and each
package reads the other's."""

import os

import numpy as np
import pytest

import ics_tpu.utils.io as jio

import ics_tpu_torch.utils.io as tio

RNG = np.random.default_rng(61)

COMPRESSIONS = [None, "packbits", "lzw", "deflate", "lzma"]


def _frame(dtype, shape=(37, 29, 3)) -> np.ndarray:
    """Blocky content (runs for PackBits, repeats for LZW) plus noise."""
    base = np.kron(RNG.random((shape[0] // 8 + 1, shape[1] // 8 + 1, shape[2])),
                   np.ones((8, 8, 1)))[: shape[0], : shape[1]]
    img = 0.7 * base + 0.3 * RNG.random(shape)
    if dtype == np.float32:
        return img.astype(np.float32)
    return (img * np.iinfo(dtype).max).astype(dtype)


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_imsave_writes_the_same_bytes_as_jax(tmp_path, dtype, compression):
    arr = _frame(dtype)
    mine, ref = str(tmp_path / "t.tif"), str(tmp_path / "j.tif")
    tio.imsave(mine, arr, compression=compression)
    jio.imsave(ref, arr, compression=compression)
    with open(mine, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("writer,reader", [(tio, jio), (jio, tio)])
def test_each_package_reads_the_others_files(tmp_path, writer, reader, compression):
    for dtype, shape in [(np.uint16, (33, 41, 3)), (np.uint8, (20, 17)),
                         (np.float32, (9, 11, 4))]:
        arr = _frame(dtype, shape if len(shape) == 3 else shape + (1,)).reshape(shape)
        path = str(tmp_path / f"x_{np.dtype(dtype).name}.tif")
        writer.imsave(path, arr, compression=compression)
        got = reader.imread(path)
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)


def test_save_names_and_casts_like_jax(tmp_path):
    pic = _frame(np.float32) * 65535.0
    tio.save(pic, "shot-deblurred", str(tmp_path))
    jio.save(pic, "ref", str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["ref.tif", "shot-deblurred.tif"]
    got = jio.imread(str(tmp_path / "shot-deblurred.tif"))
    assert got.dtype == np.uint16 and got.shape == pic.shape
    with open(tmp_path / "shot-deblurred.tif", "rb") as f, open(tmp_path / "ref.tif", "rb") as g:
        assert f.read() == g.read()


def test_multipage_bigtiff_tiled_and_description_cross_read(tmp_path):
    stack = _frame(np.uint16, (4, 23, 19))  # four (23, 19) pages
    tio.imsave_pages(str(tmp_path / "pages.tif"), stack, compression="lzw")
    np.testing.assert_array_equal(jio.imread(str(tmp_path / "pages.tif"), pages=True), stack)
    jio.imsave_pages(str(tmp_path / "jpages.tif"), stack)
    np.testing.assert_array_equal(tio.imread(str(tmp_path / "jpages.tif"), pages=True), stack)

    arr = _frame(np.uint16, (40, 50, 3))
    tio.imsave_bigtiff(str(tmp_path / "big.tif"), arr, compression="deflate")
    np.testing.assert_array_equal(jio.imread(str(tmp_path / "big.tif")), arr)
    tio.imsave_tiled(str(tmp_path / "tiled.tif"), arr, tile=(16, 16))
    np.testing.assert_array_equal(jio.imread(str(tmp_path / "tiled.tif")), arr)

    tio.imsave(str(tmp_path / "d.tif"), arr, description="ImageJ=1.53")
    assert jio.read_description(str(tmp_path / "d.tif")) == "ImageJ=1.53"
    assert tio.read_description(str(tmp_path / "d.tif")) == "ImageJ=1.53"


def test_memmap_and_sequence_read_like_jax(tmp_path):
    mm = tio.memmap_create(str(tmp_path / "mm.tif"), (12, 10, 3))
    mm[:] = _frame(np.uint16, (12, 10, 3))
    mm.flush()
    np.testing.assert_array_equal(jio.imread(str(tmp_path / "mm.tif")), np.asarray(mm))
    for i in range(3):
        jio.imsave(str(tmp_path / f"f{i}.tif"), _frame(np.uint8, (8, 9, 3)))
    pattern = str(tmp_path / "f*.tif")
    np.testing.assert_array_equal(tio.imread_sequence(pattern),
                                  jio.imread_sequence(pattern, prefetch=False))
    np.testing.assert_array_equal(tio.load_image(str(tmp_path / "f1.tif")),
                                  jio.load_image(str(tmp_path / "f1.tif")))
