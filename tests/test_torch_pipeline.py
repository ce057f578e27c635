"""The port's deblur pipeline against ``ics_tpu.deblur_module`` on the CPU."""

import contextlib
import io

import numpy as np
import pytest
import scipy.signal as sig

import ics_tpu
from ics_tpu.models.checkpoint import SolverCheckpoint, load_checkpoint, save_checkpoint
from ics_tpu.ops.windows import gaussian_kernel
from ics_tpu.utils.metrics import ssim

import ics_tpu_torch
from ics_tpu_torch.utils.trace import Tracer

RNG = np.random.default_rng(53)


def _blocky(blocks: int, size: int, blur: int, bits: int = 8) -> np.ndarray:
    """The blurred-blocks fixture of tests/test_pipeline.py:61-71, kept
    away from 0 (the DoF division has no epsilon)."""
    sharp = np.kron(
        0.25 + 0.6 * RNG.random((blocks, blocks, 3)), np.ones((size, size, 1))
    ).astype(np.float32)
    k = gaussian_kernel(blur, 1.0)
    blurry = np.stack(
        [sig.convolve(sharp[..., c], k, mode="same") for c in range(3)], axis=-1
    )
    top = 2**bits - 1
    dtype = np.uint8 if bits == 8 else np.uint16
    return np.clip(blurry * top, 0, top).astype(dtype)


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


FIXTURE = _blocky(12, 8, 3)
TWO_LEVEL = _blocky(16, 8, 5)

CASES = {
    # single-level pyramid, blind + non-blind (the test_pipeline.py case)
    "blocky": (FIXTURE, 3, dict(mask_size=31, iterations=4, tolerance=10.0)),
    # two pyramid levels, 0.707 and 1.0
    "two-level": (TWO_LEVEL, 5, dict(mask_size=61, iterations=10, tolerance=10.0)),
    "motion": (TWO_LEVEL, 5, dict(mask_size=61, iterations=6, blur="motion")),
    "final+budget": (TWO_LEVEL, 5, dict(mask_size=61, iterations=6,
                                        nonblind_levels="final", blind_budget=2)),
    "early-stop": (TWO_LEVEL, 5, dict(mask_size=61, iterations=12, early_stop=0.3)),
    "16-bit odd": (_blocky(9, 7, 3, bits=16)[:, :62], 3,
                   dict(mask_size=21, iterations=4, bits=16, mask=[30, 33])),
}


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_jax(name):
    pic, blur_width, kw = CASES[name]
    kw = dict(kw, verbose=False)
    want_stats, got_stats = [], []
    want = _quiet(ics_tpu.deblur_module, pic, "x", None, blur_width,
                  stats_out=want_stats, **kw)
    got = _quiet(ics_tpu_torch.deblur_module, pic, "x", None, blur_width,
                 stats_out=got_stats, device="cpu", **kw)
    assert got.dtype == np.uint16 and got.shape == want.shape
    assert ssim(got / 65535.0, want / 65535.0) >= 0.999
    assert [(s["case"], s["k"], s["result"].iterations) for s in got_stats] == [
        (s["case"], s["k"], s["result"].iterations) for s in want_stats
    ]


def test_preview_matches_jax():
    kw = dict(mask_size=61, iterations=4, preview=True, verbose=False)
    want = _quiet(ics_tpu.deblur_module, TWO_LEVEL, "x", None, 5, **kw)
    got = _quiet(ics_tpu_torch.deblur_module, TWO_LEVEL, "x", None, 5, device="cpu", **kw)
    assert got.shape == want.shape
    assert ssim(got / 65535.0, want / 65535.0) >= 0.999


def test_psf_saved_by_ics_tpu_loads_in_the_port(tmp_path):
    psf = np.dstack([gaussian_kernel(5, 1.2)] * 3).astype(np.float32)
    path = str(tmp_path / "psf.npz")
    save_checkpoint(path, SolverCheckpoint(psf=psf, blur_width=5))
    kw = dict(mask_size=61, iterations=6, verbose=False, psf_path=path)
    want = _quiet(ics_tpu.deblur_module, TWO_LEVEL, "x", None, 3, **kw)
    got = _quiet(ics_tpu_torch.deblur_module, TWO_LEVEL, "x", None, 3, device="cpu", **kw)
    assert ssim(got / 65535.0, want / 65535.0) >= 0.999


def test_psf_saved_by_the_port_loads_in_ics_tpu(tmp_path):
    path = str(tmp_path / "est.npz")
    stats = []
    _quiet(ics_tpu_torch.deblur_module, FIXTURE, "x", None, 3, mask_size=31,
           iterations=3, verbose=True, save_psf_path=path, stats_out=stats,
           device="cpu")
    ckpt = load_checkpoint(path)
    assert ckpt.psf.shape == (3, 3, 3) and ckpt.blur_width == 3
    np.testing.assert_array_equal(ckpt.psf, stats[0]["result"].psf.numpy())


def test_compute_timer_and_trace():
    timer, tracer = {}, Tracer()
    out = _quiet(ics_tpu_torch.deblur_module, FIXTURE, "x", None, 3, mask_size=31,
                 iterations=2, compute_timer=timer, trace=tracer, device="cpu")
    assert out.shape == FIXTURE.shape
    assert timer.get("compute_s", 0.0) > 0.0 and "_t0" not in timer
    report = tracer.report()
    assert "solve (blind)" in report and "solve (non-blind)" in report


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(blur_width=1), "at least 3"),
        (dict(blur_width=4), "odd"),
        (dict(blur_width=3, mask=[2, 2], mask_size=33), "outside the picture"),
        (dict(blur_width=3, mask_size=31, precision="float16"), "unknown precision"),
        (dict(blur_width=3, mask_size=31, blind_budget=0), "blind_budget"),
        (dict(blur_width=3, mask_size=31, solver="admm"), "unknown solver"),
        (dict(blur_width=3, mask_size=31, nonblind_levels="some"), "nonblind_levels"),
        (dict(blur_width=3, psf_path="a.npz", save_psf_path="b.npz"), "mutually exclusive"),
    ],
)
def test_same_value_errors_as_jax(kw, match):
    pic = (RNG.random((64, 64, 3)) * 255).astype(np.uint8)
    for fn, extra in [(ics_tpu.deblur_module, {}),
                      (ics_tpu_torch.deblur_module, {"device": "cpu"})]:
        with pytest.raises(ValueError, match=match):
            _quiet(fn, pic, "x", None, verbose=False, **kw, **extra)


@pytest.mark.parametrize(
    "kw",
    [
        dict(dest_path="out"),
        dict(display=True),
        dict(resize_backend="scipy"),
        dict(mesh=object()),
        dict(solver="pam"),
        dict(solver="pd"),
        dict(precision="mixed"),
        dict(precision="high"),
        dict(use_tv=True),
        dict(inner_loop="pallas"),
    ],
)
def test_unported_options_raise(kw):
    kw = {"dest_path": None, **kw}
    with pytest.raises(NotImplementedError):
        _quiet(ics_tpu_torch.deblur_module, FIXTURE, "x", blur_width=3,
               mask_size=31, iterations=1, verbose=False, device="cpu", **kw)


def test_pyramid_and_pad_helpers_match_jax():
    for k in (3, 5, 7, 9, 13, 31):
        assert ics_tpu_torch.build_pyramid(k) == ics_tpu.build_pyramid(k)
    img = RNG.random((4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ics_tpu_torch.pad_image(img, ((1, 0), (2, 1))), ics_tpu.pad_image(img, ((1, 0), (2, 1)))
    )
