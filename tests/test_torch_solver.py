"""The port's RL-MM solver against the JAX solver on the CPU."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

from ics_tpu.models import rl_mm as jrl
from ics_tpu.ops.reductions import whiteness_weights
from ics_tpu.ops.windows import gaussian_kernel, uniform_kernel

from ics_tpu_torch.models import rl_mm as trl

RNG = np.random.default_rng(47)
MK, M = 5, 41
PAD = MK // 2
WIN = dict(top=PAD + 1, bottom=M - PAD - 1, left=PAD + 1, right=M - PAD - 1)


def _problem():
    base = RNG.random((M + 8, M + 8, 3)).astype(np.float32)
    k = gaussian_kernel(7, 1.5)
    smooth = np.stack(
        [sig.convolve(base[..., c], k, mode="valid") for c in range(3)], axis=-1
    )[:M, :M]
    image = np.clip(smooth, 0.2, 0.8).astype(np.float32)
    u = np.pad(image, ((PAD, PAD), (PAD, PAD), (0, 0)), mode="edge").astype(np.float32)
    psf = np.dstack([uniform_kernel(MK)] * 3).astype(np.float32)
    return image, u, psf


IMAGE, U, PSF = _problem()


def _args(**kw):
    return (IMAGE, U, PSF, *WIN.values()), kw


@pytest.mark.parametrize("blind,corr", [(False, False), (True, False), (True, True)])
def test_fixed_outer_count_matches_jax_solve(blind, corr):
    kw = dict(**WIN, tau=0.0, step_factor=1e-3, lambd=1000.0, iterations=6,
              blind=blind, correlation=corr, use_stopping=False)
    w = whiteness_weights(WIN["bottom"] - WIN["top"], WIN["right"] - WIN["left"])
    want = jrl._solve(jnp.asarray(IMAGE), jnp.asarray(U), jnp.asarray(PSF),
                      jnp.asarray(w), use_tv=False, **kw)
    got = trl._solve(torch.from_numpy(IMAGE), torch.from_numpy(U),
                     torch.from_numpy(PSF), w, **kw)
    names = ["u", "u_full", "psf", "image", "stats"]
    # u: six outers of five inner iterations in another f32 summation order
    tol = {"u": 5e-5, "u_full": 5e-5, "psf": 1e-6, "image": 0.0, "stats": 1e-6}
    for name, a, b in zip(names, want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol[name], err_msg=name)


@pytest.mark.parametrize("blind", [False, True])
def test_richardson_lucy_tau_1e9_matches_jax(blind):
    args, kw = _args(tau=1e9, iterations=8, lambd=1000.0, blind=blind)
    a = jrl.richardson_lucy_MM(*args, **kw)
    b = trl.richardson_lucy_MM(*args, device="cpu", **kw)
    assert (b.iterations, b.converged) == (a.iterations, a.converged)
    np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), atol=5e-5)
    np.testing.assert_allclose(b.u_full.numpy(), np.asarray(a.u_full), atol=5e-5)
    np.testing.assert_allclose(b.psf.numpy(), np.asarray(a.psf), atol=1e-6)
    # M_r, Hu and varu: reductions in another order
    np.testing.assert_allclose(b.stats.numpy(), np.asarray(a.stats), rtol=1e-4)


def test_whiteness_stop_matches_jax():
    # tau = 0: the non-blind parity stop fires as soon as M_r rises
    args, kw = _args(tau=0.0, iterations=40, lambd=1000.0, blind=False)
    a = jrl.richardson_lucy_MM(*args, **kw)
    b = trl.richardson_lucy_MM(*args, device="cpu", **kw)
    assert (b.iterations, b.converged) == (a.iterations, a.converged)
    np.testing.assert_allclose(b.stats.numpy(), np.asarray(a.stats), rtol=1e-4)


def test_early_stop_matches_jax():
    cfg_kw = dict(early_stop=0.5, early_stop_patience=2)
    args, kw = _args(tau=1e9, iterations=30, lambd=1000.0, blind=False)
    a = jrl.richardson_lucy_MM(*args, config=jrl.RLConfig(**cfg_kw), **kw)
    b = trl.richardson_lucy_MM(*args, config=trl.RLConfig(**cfg_kw), device="cpu", **kw)
    assert a.iterations < 30  # the plateau stop fired
    assert (b.iterations, b.converged) == (a.iterations, a.converged)


def test_record_metrics_matches_jax():
    args, kw = _args(tau=1e9, iterations=5, lambd=1000.0, blind=True)
    a = jrl.richardson_lucy_MM(*args, config=jrl.RLConfig(record_metrics=True), **kw)
    b = trl.richardson_lucy_MM(*args, config=trl.RLConfig(record_metrics=True),
                               device="cpu", **kw)
    assert set(b.trajectory) == {"M_r", "Hu", "varu"}
    for key in ("M_r", "Hu", "varu"):
        assert len(b.trajectory[key]) == b.iterations
        np.testing.assert_allclose(b.trajectory[key], a.trajectory[key], rtol=1e-4)


def test_bitwise_reproducible_on_cpu():
    args, kw = _args(tau=0.0, iterations=4, lambd=1000.0, blind=True)
    a = trl.richardson_lucy_MM(*args, device="cpu", **kw)
    b = trl.richardson_lucy_MM(*args, device="cpu", **kw)
    for x, y in [(a.u, b.u), (a.u_full, b.u_full), (a.psf, b.psf), (a.stats, b.stats)]:
        assert torch.equal(x, y)


def test_inputs_not_mutated_and_report_printed():
    u = U.copy()
    args, kw = _args(tau=0.0, iterations=2, lambd=1000.0, blind=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trl.richardson_lucy_MM(IMAGE, u, PSF, *args[3:], device="cpu", verbose=True, **kw)
    np.testing.assert_array_equal(u, U)
    assert "Stats : autocovariance" in buf.getvalue()


@pytest.mark.parametrize("tv_norm", ["channel", "collab", "collab_l2"])
@pytest.mark.parametrize("blind", [False, True])
def test_use_tv_matches_jax(tv_norm, blind):
    # blind solves stop when M_r rises whatever tau is; 4 outers stay short
    # of that on this fixture, so both run the same count
    args, kw = _args(tau=1e9, iterations=4, lambd=1000.0, blind=blind)
    cfg = dict(use_tv=True, tv_norm=tv_norm)
    a = jrl.richardson_lucy_MM(*args, config=jrl.RLConfig(**cfg), **kw)
    b = trl.richardson_lucy_MM(*args, config=trl.RLConfig(**cfg), device="cpu", **kw)
    assert (b.iterations, b.converged) == (a.iterations, a.converged) == (4, False)
    # the level-2 class: u within a few e-6, the PSF and the TV-denoised
    # image within 1e-6
    np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), atol=5e-6)
    np.testing.assert_allclose(b.psf.numpy(), np.asarray(a.psf), atol=1e-6)
    np.testing.assert_allclose(b.image.numpy(), np.asarray(a.image), atol=1e-6)
    assert not np.array_equal(b.image.numpy(), IMAGE)  # the denoise step ran
    np.testing.assert_allclose(b.stats.numpy(), np.asarray(a.stats), rtol=1e-4)


def _guard_run(pkg, img, u, psf, win, dtype, guard, lambd, iterations):
    cfg = pkg.RLConfig(dtype=dtype, dof_guard=guard)
    extra = {"device": "cpu"} if pkg is trl else {}
    res = pkg.richardson_lucy_MM(img, u, psf, *win, 0.1, iterations=iterations,
                                 step_factor=1e-3, lambd=lambd, blind=False,
                                 config=cfg, verbose=False, **extra)
    return np.asarray(res.u), res.M_r


def test_dof_guard_closes_zero_denominator_like_jax():
    # tests/test_solver.py:238-269: an exactly-zero region gives exact-zero
    # DoF denominators even in f32
    rng = np.random.default_rng(0)
    img = np.zeros((64, 64, 3), np.float32)
    img[20:40, 20:40] = rng.random((20, 20, 3)).astype(np.float32)
    psf = np.ones((5, 5, 3), np.float32) / 25.0
    u = np.pad(img, ((2, 2), (2, 2), (0, 0)), mode="edge")
    run = lambda pkg, dtype, guard: _guard_run(pkg, img, u, psf, (5, 59, 5, 59),
                                               dtype, guard, 1000, 8)
    for pkg in (jrl, trl):
        assert not np.isfinite(run(pkg, "mixed", False)[1])
        assert not np.isfinite(run(pkg, "float32", None)[0]).all()
        assert np.isfinite(run(pkg, "mixed", None)[0]).all()
    got, want = run(trl, "float32", True)[0], run(jrl, "float32", True)[0]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_dof_guard_is_bitwise_identity_where_it_cannot_fire():
    # tests/test_solver.py:272-295: no zero denominator and dof <= 1
    rng = np.random.default_rng(3)
    img = (0.1 + 0.8 * rng.random((48, 48, 3))).astype(np.float32)
    psf = np.ones((3, 3, 3), np.float32) / 9.0
    u = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    run = lambda pkg, guard: _guard_run(pkg, img, u, psf, (4, 44, 4, 44), "float32",
                                        guard, 1e12, 6)[0]
    np.testing.assert_array_equal(run(trl, True), run(trl, False))
    np.testing.assert_allclose(run(trl, True), run(jrl, True), atol=1e-6)


def test_dof_guard_clamps_near_zero_amplifier_like_jax():
    # tests/test_solver.py:298-332: lambd=1 leaves dof undamped
    rng = np.random.default_rng(7)
    img = (0.1 + 0.8 * rng.random((48, 48, 3))).astype(np.float32)
    psf = np.ones((3, 3, 3), np.float32) / 9.0
    u = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    run = lambda pkg, guard: _guard_run(pkg, img, u, psf, (4, 44, 4, 44), "float32",
                                        guard, 1.0, 6)[0]
    unguarded, guarded = run(trl, False), run(trl, True)
    assert np.nanmax(np.abs(unguarded)) > 2.0 or not np.isfinite(unguarded).all()
    assert np.isfinite(guarded).all() and np.abs(guarded).max() < 1.5
    np.testing.assert_allclose(guarded, run(jrl, True), atol=1e-5)


def _crop_fixture():
    """A structured 101x101 crop in [0.15, 0.9] (blocks, an edge ramp and
    texture, blurred by a 7x7 Gaussian), gamma-decoded as the pipeline
    does: the stand-in for the reference photo crop of
    tests/test_solver.py:199-235."""
    rng = np.random.default_rng(29)
    m, mk = 101, 7
    yy, xx = np.mgrid[0:m + 12, 0:m + 12] / (m + 12.0)
    img = 0.3 + 0.3 * xx[..., None] + 0.1 * yy[..., None] + np.zeros((1, 1, 3))
    for _ in range(12):
        y0, x0 = rng.integers(0, m, 2)
        h, w = rng.integers(8, 30, 2)
        img[y0 : y0 + h, x0 : x0 + w] += rng.uniform(-0.25, 0.25, 3)
    img += 0.03 * np.kron(rng.uniform(-1, 1, ((m + 12) // 4 + 1,) * 2 + (3,)),
                          np.ones((4, 4, 1)))[: m + 12, : m + 12]
    k = gaussian_kernel(mk, 1.5)
    blurred = np.stack([sig.convolve(img[..., c], k, mode="valid") for c in range(3)], -1)
    crop = (np.clip(blurred[:m, :m], 0.15, 0.9) ** (1 / 2.2)).astype(np.float32)
    pad = mk // 2
    u0 = np.pad(crop, ((pad, pad), (pad, pad), (0, 0)), mode="edge").astype(np.float32)
    psf0 = np.dstack([uniform_kernel(mk)] * 3).astype(np.float32)
    return (crop, u0, psf0, pad + 1, m - pad - 1, pad + 1, m - pad - 1)


CROP = _crop_fixture()


@pytest.mark.parametrize("tau,iterations", [(10.0, 25), (0.0, 30)])
def test_mixed_matches_jax_mixed(tau, iterations):
    from ics_tpu.utils.metrics import ssim

    # tau=10: a fixed 25 outers; tau=0: the real stopping rule
    kw = dict(tau=tau, iterations=iterations, step_factor=1e-3, lambd=10000.0, blind=False)
    a = jrl.richardson_lucy_MM(*CROP, config=jrl.RLConfig(dtype="mixed"), **kw)
    b = trl.richardson_lucy_MM(*CROP, config=trl.RLConfig(dtype="mixed"), device="cpu", **kw)
    assert (b.iterations, b.converged) == (a.iterations, a.converged)
    assert ssim(b.u.numpy(), np.asarray(a.u), data_range=1.0) >= 0.999


@pytest.mark.parametrize("blind", [False, True])
def test_bfloat16_close_to_f32(blind):
    from ics_tpu.utils.metrics import ssim

    # tests/test_solver.py:128-143
    args, kw = _args(tau=0.0, iterations=6, lambd=1000.0, blind=blind)
    f32 = trl.richardson_lucy_MM(*args, device="cpu", **kw)
    b = trl.richardson_lucy_MM(*args, config=trl.RLConfig(dtype="bfloat16"), device="cpu", **kw)
    j = jrl.richardson_lucy_MM(*args, config=jrl.RLConfig(dtype="bfloat16"), **kw)
    assert b.u.dtype == torch.float32 and np.isfinite(b.u.numpy()).all()
    assert ssim(b.u.numpy(), f32.u.numpy(), data_range=1.0) > 0.98
    assert ssim(b.u.numpy(), np.asarray(j.u), data_range=1.0) > 0.98


@pytest.mark.parametrize("blind", [False, True])
def test_conv_precision_high_matches_jax_high(blind):
    # mk 9 (81 taps): the port runs K4s; JAX on the CPU runs exact f32
    mk, m = 9, 45
    pad = mk // 2
    rng = np.random.default_rng(61)
    image = np.stack([sig.convolve(rng.uniform(0.2, 0.8, (m, m)), gaussian_kernel(5, 1.0),
                                   mode="same", method="direct") for _ in range(3)], -1)
    image = image.astype(np.float32)
    u = np.pad(image, ((pad, pad), (pad, pad), (0, 0)), mode="edge").astype(np.float32)
    psf = np.dstack([uniform_kernel(mk)] * 3).astype(np.float32)
    win = (pad + 1, m - pad - 1, pad + 1, m - pad - 1)
    kw = dict(tau=1e9, iterations=3, lambd=1000.0, blind=blind)
    cfg = dict(conv_precision="high", dof_guard=True)
    a = jrl.richardson_lucy_MM(image, u, psf, *win, config=jrl.RLConfig(**cfg), **kw)
    b = trl.richardson_lucy_MM(image, u, psf, *win, config=trl.RLConfig(**cfg),
                               device="cpu", **kw)
    assert b.iterations == a.iterations
    # measured on the CPU: u within 1.1e-6 non-blind and 6e-8 blind (exact
    # f32 against JAX: 1.8e-7 and 6e-8), psf within 7.5e-9; the bounds
    # leave about 5x and 13x
    np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), atol=5e-6)
    np.testing.assert_allclose(b.psf.numpy(), np.asarray(a.psf), atol=1e-7)


@pytest.mark.parametrize(
    "cfg,err,match",
    [
        (dict(conv_precision="bogus"), ValueError, "conv_precision"),
        (dict(use_tv=True, tv_norm="l1"), ValueError, "tv_norm"),
        (dict(dtype="float16"), ValueError, "dtype"),
        (dict(psf_grad="fft"), ValueError, "psf_grad"),
        (dict(conv_method="direct"), NotImplementedError, "ROADMAP"),
    ],
)
def test_bad_solver_options_raise(cfg, err, match):
    args, kw = _args(tau=0.0, iterations=1)
    with pytest.raises(err, match=match):
        trl.richardson_lucy_MM(*args, config=trl.RLConfig(**cfg), device="cpu", **kw)


def _window(m, mk, seed):
    """A smooth (m, m) image in [0.2, 0.8], its edge-padded window and a
    flat PSF (tests/test_pallas.py:148-158)."""
    rng = np.random.default_rng(seed)
    pad = mk // 2
    base = rng.random((m + 8, m + 8, 3)).astype(np.float32)
    smooth = np.stack([sig.convolve(base[..., c], gaussian_kernel(7, 1.5), mode="valid")
                       for c in range(3)], axis=-1)[:m, :m]
    image = np.clip(smooth, 0.2, 0.8).astype(np.float32)
    u = np.pad(image, ((pad, pad), (pad, pad), (0, 0)), mode="edge").astype(np.float32)
    psf = np.dstack([uniform_kernel(mk)] * 3).astype(np.float32)
    return image, u, psf, (pad + 1, m - pad - 1, pad + 1, m - pad - 1)


@pytest.mark.parametrize("inner_loop", ["xla", "pallas", "pallas_unrolled"])
@pytest.mark.parametrize("mk", [3, 7])
@pytest.mark.parametrize("blind", [False, True])
def test_inner_loop_matches_jax(inner_loop, mk, blind):
    # about 31^2, 4 outers at a fixed count; JAX runs its Pallas inner loop
    # in interpret mode on the CPU, the port K2's plain twin
    # seeds whose blind M_r falls by >= 1.9e-5 relative each outer: no stop
    image, u, psf, win = _window(31 - mk + 1 + mk // 2 * 2, mk, seed={3: 0, 7: 2}[mk])
    kw = dict(tau=1e9, iterations=4, step_factor=1e-3, lambd=1000.0, blind=blind)
    a = jrl.richardson_lucy_MM(image, u, psf, *win, config=jrl.RLConfig(inner_loop=inner_loop),
                               **kw)
    b = trl.richardson_lucy_MM(image, u, psf, *win, config=trl.RLConfig(inner_loop=inner_loop),
                               device="cpu", **kw)
    assert (b.iterations, b.converged) == (a.iterations, a.converged)
    np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), atol=1e-5)
    np.testing.assert_allclose(b.psf.numpy(), np.asarray(a.psf), atol=1e-5)


_ROUTE = dict(device_type="cuda", fits=True, use_tv=False, guard=False,
              compute=torch.float32, mixed=False)


@pytest.mark.parametrize(
    "inner_loop,change,want",
    [
        ("auto", {}, "kernel"),
        ("pallas", {}, "kernel"),
        ("pallas_unrolled", {}, "kernel"),
        ("xla", {}, "ops"),
        # the JAX package's fallbacks (ics_tpu/models/rl_mm.py:341-365)
        ("pallas", dict(use_tv=True), "ops"),
        ("pallas", dict(fits=False), "ops"),
        ("pallas", dict(guard=True), "ops"),
        ("pallas", dict(compute=torch.bfloat16), "ops"),
        ("pallas", dict(mixed=True), "ops"),
        ("pallas_unrolled", dict(guard=True), "ops"),
        ("auto", dict(fits=False), "ops"),
        ("auto", dict(use_tv=True), "ops"),
        ("auto", dict(mixed=True), "ops"),
        # the CPU: the kernel's plain twin where JAX runs its kernel in
        # interpret mode; 'auto' takes the kernel on CUDA only
        ("pallas", dict(device_type="cpu"), "kernel"),
        ("pallas", dict(device_type="cpu", use_tv=True), "ops"),
        ("auto", dict(device_type="cpu"), "ops"),
        ("xla", dict(device_type="cpu"), "ops"),
    ],
)
def test_inner_loop_route(inner_loop, change, want):
    assert trl.inner_loop_route(inner_loop, **{**_ROUTE, **change}) == want


def test_inner_loop_window_bound_is_the_jax_one():
    from ics_tpu.ops.pallas_solver import fits_vmem

    from ics_tpu_torch.ops.cuda_solver import fits

    for side in (31, 262, 330, 331, 369, 520):
        assert fits(side, side) == fits_vmem(side, side)


def test_unknown_inner_loop_raises():
    args, kw = _args(tau=0.0, iterations=1)
    with pytest.raises(ValueError, match="inner_loop"):
        trl.richardson_lucy_MM(*args, config=trl.RLConfig(inner_loop="fused"), device="cpu",
                               **kw)
