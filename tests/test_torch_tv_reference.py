"""TV-MM with its total-variation terms live (``deblur_module(use_tv=True)``)
against the benchmark's plain reference of that method
(``benchmark/reference/mm_tv.py``) on the CPU, under the limits of the
``cam24-tv`` configuration; the reference's TV stencil against a float64
NumPy transcription of the published stencil; and three planted faults of
the program, each over at least one limit."""

from __future__ import annotations

import contextlib
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import scenes
from benchmark.reference import mm_tv
from benchmark.run import HERE, Cell, _Levels, _load
from ics_tpu_torch.models import rl_mm
from ics_tpu_torch.models.pipeline import deblur_module

ROOT = Path(__file__).resolve().parents[1]
# the configuration's limits, but two of the full-frame level's: at 96 x 128
# the non-blind TV solves run 3-200 outers where the 24 MP frame's run 3-5,
# and eight scenes read fine_hp_gap up to 1.1e-4 and last_stop_gap up to
# 5.3e-3 (PERF.md section 2 (c)); a fault confined to the non-blind levels
# reads 2.4e-3 and 0.53 or more
LIMITS = dict(Cell("cam24-tv.blind", ROOT).limits, fine_hp_gap=3e-4, last_stop_gap=2e-2)
KW = dict(blur_width=5, mask=[48, 64], mask_size=31, tolerance=0.1, quality="normal",
          iterations=200, blur="static", solver="mm", precision="exact", use_tv=True,
          tv_norm="channel")
SEED = 5  # the scene: on it the blind 0.707 level runs 175 outers, the planted faults' room


@pytest.fixture(autouse=True)
def _one_thread():
    """One CPU thread: the many small tensors of these solves run slower on
    more, and far slower where several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numbers(frame, kw):
    """The program's levels held against the reference, as a benchmark run
    holds them."""
    levels = _Levels(keep=True)
    with contextlib.redirect_stdout(None):
        got = deblur_module(frame, "f", None, verbose=False, stats_out=levels, device="cpu",
                            **kw)
    return mm_tv.run(frame, kw, "cpu", follow=levels.records(), program_codes=got)


def _over(found):
    return {k: (found[k], v) for k, v in LIMITS.items() if found[k] > v}


@pytest.mark.parametrize("stored", [False, True], ids=["blind", "stored-psf"])
def test_the_port_agrees_with_the_reference_within_the_limits(stored):
    kw = dict(KW)
    if stored:  # the true PSF, stored once: the non-blind levels alone
        kw.update(_load(HERE / "traffic/stored-psf.py").prepare(
            SimpleNamespace(config=dict(kwargs=kw)), Path(tempfile.mkdtemp())))
    found = _numbers(scenes.make_scene(96, 128, 5, SEED, "cpu"), kw)
    assert not _over(found), found
    assert found["post_gap"] == 0
    assert (found["psf_gap"] > 0) != stored  # the blind levels were compared, or none ran


def _transcription(u, eps, norm):
    """SURVEY.md C4 (lib/deconvolution.pyx:137-239), order 2, in float64 loops
    over the interior: the second differences along rows, columns and both
    diagonals (these over sqrt(2)), ``div`` minus their sum, ``tv`` the
    ε-regularised norm of each pair, summed; both over ``adjust``; the ring
    left at 0."""
    c, h, w = u.shape
    adjust = 4.0 * (1.0 + 1.0 / np.sqrt(2.0)) if norm == 1 else 2.0 * (1.0 + np.sqrt(2.0))
    tv, div = np.zeros_like(u), np.zeros_like(u)
    for k in range(c):
        for i in range(1, h - 1):
            for j in range(1, w - 1):
                x = u[k, i, j]
                a = u[k, i - 1, j] + u[k, i + 1, j] - 2 * x
                b = u[k, i, j - 1] + u[k, i, j + 1] - 2 * x
                d = (u[k, i - 1, j - 1] + u[k, i + 1, j + 1] - 2 * x) / np.sqrt(2.0)
                e = (u[k, i - 1, j + 1] + u[k, i + 1, j - 1] - 2 * x) / np.sqrt(2.0)
                if norm == 1:
                    t = abs(a) + abs(b) + eps + abs(d) + abs(e) + eps
                else:
                    t = np.sqrt(a * a + b * b + eps * eps) + np.sqrt(d * d + e * e + eps * eps)
                tv[k, i, j], div[k, i, j] = t / adjust, -(a + b + d + e) / adjust
    return tv, div


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("eps", [1e-2, 1e-6])
def test_the_reference_stencil_is_the_published_one(norm, eps):
    u = torch.rand((3, 9, 11), generator=torch.Generator().manual_seed(5))
    tv, div = mm_tv.tv(u, eps, norm)
    want_tv, want_div = _transcription(u.double().numpy(), eps, norm)
    np.testing.assert_allclose(tv.numpy(), want_tv, rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(div.numpy(), want_div, rtol=2e-6, atol=1e-7)
    assert not tv[:, 0].any() and not div[:, :, -1].any()


def _tv_off(monkeypatch):
    """The TV terms off: the parity step, the observation never denoised."""
    real = rl_mm.inner_loop_ops
    monkeypatch.setattr(rl_mm, "inner_loop_ops",
                        lambda u, image, psf, **kw: real(u, image, psf, **dict(kw, tv=None)))


def _denoising_skipped(monkeypatch):
    """The observation's denoising dropped: each outer starts again from the
    observation it was given, and a level returns it undenoised."""
    real = rl_mm.inner_loop_ops
    monkeypatch.setattr(rl_mm, "inner_loop_ops",
                        lambda u, image, psf, **kw: (*real(u, image, psf, **kw)[:3], image))


def _norm_two_given_one(monkeypatch):
    """Norm 2's TV call made with norm 1: its magnitude and divergence are
    norm 1's."""
    real = rl_mm._tv_lanes
    monkeypatch.setattr(rl_mm, "_tv_lanes",
                        lambda a, eps, norm, *rest: real(a, eps, 1, *rest))


def _nonblind_epsilon(monkeypatch):
    """The non-blind levels regularised with the blind levels' ε of 1e-2 in
    place of 1e-6: the blind levels are untouched."""
    monkeypatch.setattr(rl_mm, "_EPS_NONBLIND", rl_mm._EPS_BLIND)


BLIND_NUMBERS = {"denoised_gap", "blind_u_gap", "psf_gap"}  # of the blind levels alone


@pytest.mark.parametrize("fault", [_tv_off, _denoising_skipped, _norm_two_given_one,
                                   _nonblind_epsilon], ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_fails_a_limit(monkeypatch, fault):
    """The blind case of the agreement test, which passes, with a fault."""
    fault(monkeypatch)
    found = _numbers(scenes.make_scene(96, 128, 5, SEED, "cpu"), KW)
    over = _over(found)
    assert over, found
    if fault is _nonblind_epsilon:  # caught by the full-frame level's numbers alone
        assert not BLIND_NUMBERS & set(over) and {"fine_hp_gap", "last_stop_gap"} <= set(over)
