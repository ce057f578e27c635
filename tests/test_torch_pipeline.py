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
    "kw,error",
    [
        (dict(display=True), NotImplementedError),
        # mesh is ported (ROADMAP item 11): it takes a torch DeviceMesh
        (dict(mesh=object()), TypeError),
    ],
)
def test_unported_options_raise(kw, error):
    kw = {"dest_path": None, **kw}
    with pytest.raises(error):
        _quiet(ics_tpu_torch.deblur_module, FIXTURE, "x", blur_width=3,
               mask_size=31, iterations=1, verbose=False, device="cpu", **kw)


@pytest.mark.parametrize("name", ["blocky", "two-level", "motion", "final+budget"])
@pytest.mark.parametrize("solver", ["pam", "pd"])
def test_solver_variants_match_jax(solver, name):
    """TV-PAM and TV-PD through the whole pipeline: the same outer count at
    every level, SSIM >= 0.999 against ics_tpu."""
    pic, blur_width, kw = CASES[name]
    kw = dict(kw, verbose=False, solver=solver)
    want_stats, got_stats = [], []
    want = _quiet(ics_tpu.deblur_module, pic, "x", None, blur_width, stats_out=want_stats, **kw)
    got = _quiet(ics_tpu_torch.deblur_module, pic, "x", None, blur_width,
                 stats_out=got_stats, device="cpu", **kw)
    assert got.dtype == np.uint16 and got.shape == want.shape
    assert ssim(got / 65535.0, want / 65535.0) >= 0.999
    assert [(s["case"], s["k"], s["result"].iterations) for s in got_stats] == [
        (s["case"], s["k"], s["result"].iterations) for s in want_stats
    ]
    assert all(s["result"].u_full is None for s in got_stats)


@pytest.mark.parametrize("solver", ["pam", "pd"])
def test_solver_variants_preview_and_psf_checkpoint_match_jax(solver, tmp_path):
    """``preview`` (the non-blind window written back through the inner-box
    fallback) and a PSF carried across by ``save_psf_path``/``psf_path``."""
    kw = dict(mask_size=61, iterations=4, verbose=False, solver=solver)
    want = _quiet(ics_tpu.deblur_module, TWO_LEVEL, "x", None, 5, preview=True, **kw)
    got = _quiet(ics_tpu_torch.deblur_module, TWO_LEVEL, "x", None, 5, preview=True,
                 device="cpu", **kw)
    assert got.shape == want.shape
    assert ssim(got / 65535.0, want / 65535.0) >= 0.999
    path = str(tmp_path / "psf.npz")
    stats = []
    _quiet(ics_tpu_torch.deblur_module, TWO_LEVEL, "x", None, 5, save_psf_path=path,
           stats_out=stats, device="cpu", **kw)
    np.testing.assert_array_equal(load_checkpoint(path).psf, stats[1]["result"].psf.numpy())
    want = _quiet(ics_tpu.deblur_module, TWO_LEVEL, "x", None, 3, psf_path=path, **kw)
    got = _quiet(ics_tpu_torch.deblur_module, TWO_LEVEL, "x", None, 3, psf_path=path,
                 device="cpu", **kw)
    assert ssim(got / 65535.0, want / 65535.0) >= 0.999


@pytest.mark.parametrize("solver", ["pam", "pd"])
def test_solver_variants_take_config_and_ignore_the_mm_options(solver, monkeypatch):
    """As ics_tpu/models/pipeline.py:412-421 routes them: ``config`` reaches
    every solve; precision, use_tv, tv_norm, inner_loop and early_stop do
    not change the result; the solver gets no ``verbose``."""
    import ics_tpu_torch.models.pipeline as tpipe

    name = {"pam": "richardson_lucy_PAM", "pd": "richardson_lucy_PD"}[solver]
    cls = {"pam": ics_tpu_torch.PAMConfig, "pd": ics_tpu_torch.PDConfig}[solver]
    cfg = cls(lambda_tv=5e-4)
    seen = []

    def record(*a, _fn=getattr(tpipe, name), **kw):
        seen.append((kw["config"], "verbose" in kw))
        return _fn(*a, **kw)

    monkeypatch.setattr(tpipe, name, record)
    kw = dict(mask_size=31, iterations=3, verbose=False, solver=solver, device="cpu")
    plain = _quiet(ics_tpu_torch.deblur_module, FIXTURE, "x", None, 3, config=cfg, **kw)
    assert seen and set(seen) == {(cfg, False)}
    other = _quiet(ics_tpu_torch.deblur_module, FIXTURE, "x", None, 3, config=cfg,
                   precision="mixed", use_tv=True, tv_norm="collab", inner_loop="xla",
                   early_stop=0.5, **kw)
    np.testing.assert_array_equal(other, plain)


def test_write_back_falls_back_to_the_inner_box():
    """A result without ``u_full`` (PAM, PD) lands in the inner box
    [top-1 : bottom+1, left-1 : right+1], as ics_tpu/models/pipeline.py:105-107
    writes it; with ``u_full`` (MM) the whole padded window is written."""
    import torch

    from ics_tpu_torch.models.pipeline import _write_back
    from ics_tpu_torch.models.rl_mm import RLResult

    top, bottom, left, right, pad = 5, 12, 6, 15, 2
    u = torch.full((bottom - top + 2, right - left + 2, 3), 7.0)
    res = RLResult(u=u, psf=torch.ones(5, 5, 3), image=u, stats=torch.zeros(5))
    frame = _write_back(torch.zeros(30, 30, 3), res, top, bottom, left, right, pad)
    box = torch.zeros(30, 30, 3, dtype=torch.bool)
    box[top - 1 : bottom + 1, left - 1 : right + 1] = True
    assert bool((frame[box] == 7.0).all()) and bool((frame[~box] == 0.0).all())
    res.u_full = torch.full((bottom - top + 2 + 2 * pad, right - left + 2 + 2 * pad, 3), 3.0)
    frame = _write_back(torch.zeros(30, 30, 3), res, top, bottom, left, right, pad)
    assert int((frame == 3.0).sum()) == res.u_full.numel()


@pytest.mark.parametrize("inner_loop", ["xla", "pallas", "pallas_unrolled"])
def test_inner_loop_matches_jax(inner_loop):
    """Each inner loop through the whole pipeline (JAX runs its Pallas inner
    loop in interpret mode on the CPU, the port K2's plain twin)."""
    pic, blur_width, kw = CASES["blocky"]
    kw = dict(kw, verbose=False, inner_loop=inner_loop)
    want_stats, got_stats = [], []
    want = _quiet(ics_tpu.deblur_module, pic, "x", None, blur_width, stats_out=want_stats, **kw)
    got = _quiet(ics_tpu_torch.deblur_module, pic, "x", None, blur_width,
                 stats_out=got_stats, device="cpu", **kw)
    assert got.dtype == np.uint16 and got.shape == want.shape
    assert ssim(got / 65535.0, want / 65535.0) >= 0.999
    assert [s["result"].iterations for s in got_stats] == [
        s["result"].iterations for s in want_stats]


def test_inner_loop_reaches_the_solver_config(monkeypatch):
    import ics_tpu_torch.models.pipeline as tpipe

    seen = []

    def record(*a, _fn=tpipe.richardson_lucy_MM, **kw):
        seen.append(kw["config"].inner_loop)
        return _fn(*a, **kw)

    monkeypatch.setattr(tpipe, "richardson_lucy_MM", record)
    _quiet(ics_tpu_torch.deblur_module, FIXTURE, "x", None, 3, mask_size=31, iterations=1,
           inner_loop="pallas_unrolled", verbose=False, device="cpu")
    assert seen and set(seen) == {"pallas_unrolled"}


def test_unknown_inner_loop_raises_like_jax():
    kw = dict(mask_size=31, iterations=1, verbose=False, inner_loop="fused")
    with pytest.raises(ValueError, match="inner_loop"):
        _quiet(ics_tpu_torch.deblur_module, FIXTURE, "x", None, 3, device="cpu", **kw)


@pytest.mark.parametrize("preview", [False, True])
def test_dest_path_saves_the_returned_array_as_jax_names_it(tmp_path, preview):
    from ics_tpu.utils.io import imread

    kw = dict(mask_size=31, iterations=3, verbose=False, preview=preview)
    got = _quiet(ics_tpu_torch.deblur_module, FIXTURE, "shot", str(tmp_path / "t"), 3,
                 device="cpu", **kw)
    _quiet(ics_tpu.deblur_module, FIXTURE, "shot", str(tmp_path / "j"), 3, **kw)
    name = "shot-preview.tif" if preview else "shot.tif"
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == [name]
    assert sorted(p.name for p in (tmp_path / "j").iterdir()) == [name]
    saved = imread(str(tmp_path / "t" / name))
    assert saved.dtype == np.uint16
    np.testing.assert_array_equal(saved, got)
    assert ssim(saved / 65535.0, imread(str(tmp_path / "j" / name)) / 65535.0) >= 0.999


@pytest.mark.parametrize("name", ["blocky", "two-level"])
def test_scipy_resize_backend_matches_jax(name):
    pic, blur_width, kw = CASES[name]
    kw = dict(kw, verbose=False, resize_backend="scipy")
    want = _quiet(ics_tpu.deblur_module, pic, "x", None, blur_width, **kw)
    got = _quiet(ics_tpu_torch.deblur_module, pic, "x", None, blur_width, device="cpu", **kw)
    assert got.dtype == np.uint16 and got.shape == want.shape
    assert ssim(got / 65535.0, want / 65535.0) >= 0.999


def test_scipy_resize_equals_jax_package_resize():
    from ics_tpu.utils.resize import resize as jresize

    from ics_tpu_torch.utils.resize import resize

    img = RNG.random((23, 31, 3)).astype(np.float32)
    for shape in [(16, 22), (33, 45), (23, 31)]:
        np.testing.assert_array_equal(resize(img, shape), jresize(img, shape))
    np.testing.assert_array_equal(resize(img[..., 0], (9, 9)), jresize(img[..., 0], (9, 9)))


NINE = _blocky(16, 8, 9)

PRECISION_CASES = {
    # (fixture, blur width, kwargs, SSIM bound against ics_tpu)
    "mixed": (TWO_LEVEL, 5, dict(precision="mixed"), 0.999),
    # blur 9: the 9x9 convolutions of the finest levels go through K4s
    "high": (NINE, 9, dict(precision="high"), 0.999),
    "fast": (TWO_LEVEL, 5, dict(precision="fast"), 0.98),
    "use_tv collab": (TWO_LEVEL, 5, dict(use_tv=True, tv_norm="collab"), 0.999),
}


@pytest.mark.parametrize("name", list(PRECISION_CASES))
def test_precision_and_tv_modes_match_jax(name):
    pic, blur_width, kw, bound = PRECISION_CASES[name]
    kw = dict(dict(mask_size=61, iterations=6, tolerance=10.0), **kw, verbose=False)
    want = _quiet(ics_tpu.deblur_module, pic, "x", None, blur_width, **kw)
    got = _quiet(ics_tpu_torch.deblur_module, pic, "x", None, blur_width, device="cpu", **kw)
    assert got.dtype == np.uint16 and got.shape == want.shape
    assert ssim(got / 65535.0, want / 65535.0) >= bound


@pytest.mark.parametrize("precision", ["hybrid", "hybrid-high"])
@pytest.mark.parametrize("min_pixels", [7921, 7922, 2_000_000])
def test_hybrid_level_configs_match_jax(precision, min_pixels, monkeypatch):
    """The per-level config rule of 'hybrid'/'hybrid-high', with the size
    threshold moved onto the fixture's one coarse level (89x89 = 7921 px
    before the safety pad): at 7921 it deviates, at 7922 and at the real
    2 MP it does not.  Both pipelines must hand each solve the same dtype,
    conv precision and guard."""
    import ics_tpu.models.pipeline as jpipe

    import ics_tpu_torch.models.pipeline as tpipe

    seen = {}
    for mod in (jpipe, tpipe):
        monkeypatch.setattr(mod, "_HYBRID_MIN_PIXELS", min_pixels)
        calls = seen.setdefault(mod.__name__, [])

        def record(*a, _fn=mod.richardson_lucy_MM, _calls=calls, **kw):
            cfg = kw["config"]
            _calls.append((kw["blind"], tuple(a[0].shape[:2]), cfg.dtype,
                           cfg.conv_precision, cfg.dof_guard))
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, "richardson_lucy_MM", record)
    kw = dict(mask_size=61, iterations=2, tolerance=10.0, precision=precision,
              verbose=False)
    _quiet(ics_tpu.deblur_module, TWO_LEVEL[:125, :125], "x", None, 5, **kw)
    _quiet(ics_tpu_torch.deblur_module, TWO_LEVEL[:125, :125], "x", None, 5,
           device="cpu", **kw)
    got = seen[tpipe.__name__]
    assert got == seen[jpipe.__name__]
    (coarse,) = [c for c in got if not c[0] and c[1][0] < 125]
    deviates = (coarse[1][0] - 2) * (coarse[1][1] - 2) >= min_pixels
    assert (coarse[2:] != ("float32", "exact", None)) == deviates


def test_pyramid_and_pad_helpers_match_jax():
    for k in (3, 5, 7, 9, 13, 31):
        assert ics_tpu_torch.build_pyramid(k) == ics_tpu.build_pyramid(k)
    img = RNG.random((4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ics_tpu_torch.pad_image(img, ((1, 0), (2, 1))), ics_tpu.pad_image(img, ((1, 0), (2, 1)))
    )
