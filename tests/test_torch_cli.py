"""The port's command line, ``main(argv, device="cpu")``, against
``ics_tpu.cli.main`` on the 64x64 fixture of tests/test_cli.py, TIFF in and
TIFF out."""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ics_tpu
from ics_tpu.cli import main as jmain
from ics_tpu.utils.io import imread, imsave
from ics_tpu.utils.metrics import ssim

import ics_tpu_torch.models.pipeline as tpipe
from ics_tpu_torch.cli import main as tmain

RNG = np.random.default_rng(81)


@pytest.fixture()
def small_image(tmp_path):
    arr = np.clip(
        np.kron(60 + 140 * RNG.random((8, 8, 3)), np.ones((8, 8, 1))), 0, 255
    ).astype(np.uint8)
    path = tmp_path / "in.tif"
    imsave(str(path), arr)
    return str(path), arr


def _both(argv, tmp_path, out_name):
    """Run both command lines on ``argv`` (input first, dest inserted);
    returns (port output, JAX output) read back from their TIFFs."""
    outs = []
    for tag, run in [("t", lambda a: tmain(a, device="cpu")), ("j", jmain)]:
        dest = str(tmp_path / tag)
        with contextlib.redirect_stdout(io.StringIO()):
            assert run([argv[0], argv[1], dest, *argv[2:]]) == 0
        outs.append(imread(f"{dest}/{out_name}"))
    return outs


@pytest.mark.parametrize(
    "cmd,suffix",
    [
        (["usm", "--radius", "3"], "in-usm.tif"),
        (["usm", "--method", "gauss", "--amount", "1.5"], "in-usm.tif"),
        (["bilateral", "--radius", "2"], "in-bilateral.tif"),
        (["bilateral"], "in-bilateral.tif"),
        (["bilateral-lab", "--radius", "2"], "in-bilateral-lab.tif"),
        (["bilateral-lab", "--all-channels"], "in-bilateral-lab.tif"),
        (["tv-denoise", "--weight", "0.05", "--iterations", "10"], "in-tv-denoise.tif"),
        (["tv-denoise"], "in-tv-denoise.tif"),
    ],
)
def test_cli_filters_match_jax(small_image, tmp_path, cmd, suffix):
    path, arr = small_image
    got, want = _both([cmd[0], path, *cmd[1:]], tmp_path, suffix)
    assert got.dtype == np.uint16 and got.shape == arr.shape
    # float32 rounding differences move a truncated 16-bit code by at most 1
    assert np.abs(got.astype(np.int32) - want).max() <= 1


def test_cli_16bit_input_matches_jax(small_image, tmp_path):
    _, arr = small_image
    path16 = str(tmp_path / "in16.tif")
    imsave(path16, arr.astype(np.uint16) * 257)
    got, want = _both(["bilateral", path16, "--radius", "3"], tmp_path, "in16-bilateral.tif")
    assert np.abs(got.astype(np.int32) - want).max() <= 1


@pytest.mark.parametrize("extra", [[], ["--use-tv", "--tv-norm", "collab"], ["--preview"]])
def test_cli_deblur_matches_jax(small_image, tmp_path, extra):
    path, arr = small_image
    name = "in-deblurred-preview.tif" if extra == ["--preview"] else "in-deblurred.tif"
    got, want = _both(["deblur", path, "--blur-width", "3", "--iterations", "3",
                       "--mask-size", "25", *extra], tmp_path, name)
    assert got.dtype == np.uint16 and got.shape == want.shape
    if not extra:
        assert got.shape == arr.shape
    assert ssim(got / 65535.0, want / 65535.0) >= 0.999


@pytest.mark.parametrize("inner_loop", ["auto", "xla", "pallas", "pallas_unrolled"])
def test_cli_deblur_inner_loop_matches_jax(small_image, tmp_path, inner_loop):
    path, arr = small_image
    got, want = _both(["deblur", path, "--blur-width", "3", "--iterations", "3",
                       "--mask-size", "25", "--inner-loop", inner_loop], tmp_path,
                      "in-deblurred.tif")
    assert got.dtype == np.uint16 and got.shape == arr.shape
    assert ssim(got / 65535.0, want / 65535.0) >= 0.999


@pytest.mark.parametrize("extra", [[], ["--blur", "motion"], ["--preview"]])
@pytest.mark.parametrize("solver", ["pam", "pd"])
def test_cli_deblur_solver_matches_jax(small_image, tmp_path, solver, extra):
    """``--solver pam|pd``: every 16-bit code within one of ics_tpu's (both
    run the same outer counts on this fixture)."""
    path, arr = small_image
    name = "in-deblurred-preview.tif" if extra == ["--preview"] else "in-deblurred.tif"
    got, want = _both(["deblur", path, "--blur-width", "3", "--iterations", "4",
                       "--mask-size", "25", "--solver", solver, *extra], tmp_path, name)
    assert got.dtype == np.uint16 and got.shape == want.shape
    if extra != ["--preview"]:
        assert got.shape == arr.shape
    assert np.abs(got.astype(np.int32) - want).max() <= 1


@pytest.mark.parametrize(
    "flags",
    [
        ["--blur-width", "5", "--solver", "pam", "--precision", "mixed"],
        ["--blur-width", "3", "--solver", "pd", "--use-tv"],
        ["--blur-width", "5", "--profile", "fast"],
        # the profile overrides an explicit --precision exact, as in ics_tpu
        ["--blur-width", "3", "--profile", "fast", "--precision", "exact", "--blind-budget", "4"],
        ["--blur-width", "7", "--mask", "20", "30", "--mask-size", "21", "--quality", "high",
         "--bits", "16", "--confidence", "5", "--tolerance", "0.5", "--blur", "motion",
         "--nonblind-levels", "final", "--precision", "mixed", "--trace", "--suffix=-x"],
    ],
)
def test_cli_deblur_passes_the_same_kwargs_as_jax(small_image, tmp_path, monkeypatch, flags):
    path, _ = small_image
    seen = {}

    def record(tag):
        def fake(pic, name, dest, blur_width, **kw):
            seen[tag] = (np.asarray(pic).shape, name, dest, blur_width, kw)
        return fake

    monkeypatch.setattr(ics_tpu, "deblur_module", record("j"))
    monkeypatch.setattr(tpipe, "deblur_module", record("t"))
    dest = str(tmp_path / "out")
    assert jmain(["deblur", path, dest, *flags]) == 0
    assert tmain(["deblur", path, dest, *flags], device="cpu") == 0
    want_kw, got_kw = seen["j"][4], seen["t"][4]
    assert got_kw.pop("device") == torch.device("cpu")
    assert seen["t"][:4] == seen["j"][:4] and got_kw == want_kw


@pytest.mark.parametrize(
    "argv,item",
    [
        (["deblur-batch", "{dir}/f*.tif", "out", "--psf", "p.npz"], "no files match"),
        (["deblur", "{path}", "out", "--blur-width", "3", "--shard", "{too_many}"],
         "must be between 1 and"),
    ],
)
def test_unported_cli_options_exit_with_their_roadmap_item(small_image, tmp_path, argv, item):
    """``deblur-batch`` and ``--shard`` run (ROADMAP item 11); they exit with
    ics_tpu's messages on a pattern that matches nothing and on more ranks
    than the CPU has cores."""
    path, _ = small_image
    subs = {"{path}": path, "{dir}": str(tmp_path / "none"),
            "{too_many}": str((os.cpu_count() or 1) + 1)}
    argv = [subs.get(a, a).replace("{dir}", subs["{dir}"]) for a in argv]
    with pytest.raises(SystemExit) as exc:
        tmain(argv, device="cpu")
    assert item in str(exc.value.code)


def test_cli_rejects_bad_args(small_image, tmp_path):
    path, _ = small_image
    with contextlib.redirect_stderr(io.StringIO()), pytest.raises(SystemExit):
        tmain(["frobnicate", path, str(tmp_path)], device="cpu")
    with pytest.raises(SystemExit, match="--blur-width or --psf"):
        tmain(["deblur", path, str(tmp_path)], device="cpu")
    with pytest.raises(ValueError, match="odd"):
        tmain(["deblur", path, str(tmp_path), "--blur-width", "4"], device="cpu")


def test_cli_runs_on_the_gpu_by_default(small_image, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    path, _ = small_image
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain(["usm", path, str(tmp_path)])


def test_module_entry_point_prints_its_subcommands():
    out = subprocess.run([sys.executable, "-m", "ics_tpu_torch", "--help"],
                         capture_output=True, text=True, check=True).stdout
    for cmd in ("deblur", "usm", "bilateral", "bilateral-lab", "tv-denoise"):
        assert cmd in out
