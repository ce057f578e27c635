"""The port's examples (``ics_tpu_torch/examples/``) on a 64x64 TIFF on the
CPU: hsv_color_balance and chroma_denoise's noisy input against the JAX
examples (``examples/``, loaded by path) within one 16-bit code,
chroma_denoise's three TV solves within 1e-6 of JAX's when both are cut to
their first outers and at SSIM >= 0.999 at the full 150; deblur_cases and
shard_deblur give finite uint16 of the input's shape.

The full TV solves are held at the North star's third parity level, not
to one code: the TV-MM step switches a pixel between its live and dead
branch on an exact zero of its TV magnitude and divides by that
magnitude, so an ulp between the frameworks moves the per-channel step of
the whole window.  On this frame 'channel' and 'collab' agree within 6e-7
after 6 outers and differ by 1e-4 after 8; 'collab_l2' agrees within
3e-7 after 2 outers, and from its third on an ulp moves it further: one
ulp added to the JAX example's own input moves JAX's 'collab_l2' result
by up to 4.8e-5 after 5 outers."""

import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

from ics_tpu_torch.examples import chroma_denoise, deblur_cases, hsv_color_balance, shard_deblur
from ics_tpu_torch.utils.io import imread, imsave
from ics_tpu_torch.utils.metrics import ssim
from ics_tpu_torch.utils.selftest import make_scene

JAX_EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the 64^2 solves are launch-bound, and the suite's
    parallel workers oversubscribe the cores otherwise."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    path = tmp_path_factory.mktemp("frame") / "scene.tif"
    imsave(str(path), make_scene(64, 64, 5, seed=11)[1])
    return str(path)


def _pair(got_path, want_path):
    got, want = imread(str(got_path)), imread(str(want_path))
    assert got.dtype == want.dtype == np.uint16 and got.shape == want.shape == (64, 64, 3)
    return got, want


def _codes_close(got_path, want_path):
    got, want = _pair(got_path, want_path)
    assert int(np.abs(got.astype(np.int32) - want).max()) <= 1


def test_chroma_denoise_matches_jax(frame, tmp_path, capsys):
    chroma_denoise.main([frame, str(tmp_path / "port"), "--device", "cpu"])
    runpy.run_path(str(JAX_EXAMPLES / "chroma_denoise.py"))["main"]([frame, str(tmp_path / "jax")])
    _codes_close(tmp_path / "port" / "noisy.tif.tif", tmp_path / "jax" / "noisy.tif.tif")
    for name in ("channel", "collab", "collab_l2"):
        got, want = _pair(tmp_path / "port" / f"{name}.tif.tif",
                          tmp_path / "jax" / f"{name}.tif.tif")
        assert ssim(got / 65535.0, want / 65535.0, device="cpu") >= 0.999


# outers after which the two frameworks still agree to the ulp level (the
# module's docstring)
FIRST_OUTERS = {"channel": 6, "collab": 6, "collab_l2": 2}


def test_chroma_denoise_first_outers_match_jax(frame, tmp_path, monkeypatch, capsys):
    """Both examples' three TV solves cut to their first outers
    (``FIRST_OUTERS``): u within 1e-6, the same outer counts."""
    jax_main = runpy.run_path(str(JAX_EXAMPLES / "chroma_denoise.py"))["main"]
    kept = {"port": [], "jax": []}

    def cut(solve, into):
        def run(*args, **kwargs):
            cut_to = FIRST_OUTERS[kwargs["config"].tv_norm]
            res = solve(*args, **{**kwargs, "iterations": cut_to})
            into.append((np.asarray(res.u), int(res.iterations)))
            return res
        return run

    monkeypatch.setattr(chroma_denoise, "richardson_lucy_MM",
                        cut(chroma_denoise.richardson_lucy_MM, kept["port"]))
    monkeypatch.setitem(jax_main.__globals__, "richardson_lucy_MM",
                        cut(jax_main.__globals__["richardson_lucy_MM"], kept["jax"]))
    chroma_denoise.main([frame, str(tmp_path / "port"), "--device", "cpu"])
    jax_main([frame, str(tmp_path / "jax")])
    assert len(kept["port"]) == len(kept["jax"]) == 3
    for (got, n_got), (want, n_want) in zip(kept["port"], kept["jax"]):
        assert got.shape == want.shape and n_got == n_want
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_hsv_color_balance_matches_jax(frame, tmp_path, monkeypatch, capsys):
    hsv_color_balance.main([frame, str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["hsv_color_balance.py", frame, str(tmp_path / "jax")])
    runpy.run_path(str(JAX_EXAMPLES / "hsv_color_balance.py"), run_name="__main__")
    _codes_close(tmp_path / "port" / "scene-hue-shift.tif", tmp_path / "jax" / "scene-hue-shift.tif")


def test_examples_read_their_default_input_from_reference(tmp_path, monkeypatch, capsys):
    """Without an input path an example reads the JAX example's default
    file name in ``--reference``."""
    import PIL.Image

    monkeypatch.chdir(tmp_path)  # the default destination is ./out
    (tmp_path / "images").mkdir()
    PIL.Image.fromarray(make_scene(48, 40, 5, seed=4)[1]).save(
        tmp_path / "images" / "153412-crop.jpg", quality=95)
    hsv_color_balance.main(["--reference", "images", "--device", "cpu"])
    out = imread(str(tmp_path / "out" / "153412-crop-hue-shift.tif"))
    assert out.dtype == np.uint16 and out.shape == (48, 40, 3)


def _finite_uint16(path):
    out = imread(str(path))
    assert out.dtype == np.uint16 and out.shape == (64, 64, 3)
    assert out.max() > 0


@pytest.mark.parametrize("case", ["crop", "motion"])
def test_deblur_cases_on_a_tiff(frame, tmp_path, case, capsys):
    deblur_cases.main([case, "--input", frame, "--dest", str(tmp_path), "--mask", "32", "32",
                       "--mask-size", "31", "--iterations", "4", "--device", "cpu"])
    _finite_uint16(tmp_path / f"{deblur_cases.CASES[case][1]}.tif")


def test_shard_deblur_on_two_cpu_ranks(frame, tmp_path, capfd):
    shard_deblur.main([frame, str(tmp_path), "--shard", "2", "--device", "cpu",
                       "--blur-width", "5", "--mask-size", "31", "--iterations", "4"])
    _finite_uint16(tmp_path / "scene-sharded.tif")
    assert "mesh: 2 x cpu ranks" in capfd.readouterr().out


def test_examples_default_to_the_gpu(frame, tmp_path):
    """No fallback hides the card: without CUDA the default device raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    for main in (chroma_denoise.main, hsv_color_balance.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main([frame, str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        deblur_cases.main(["crop", "--input", frame, "--dest", str(tmp_path)])
