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


@pytest.mark.parametrize(
    "cfg",
    [
        dict(use_tv=True),
        dict(dtype="mixed"),
        dict(dtype="bfloat16"),
        dict(conv_precision="high"),
        dict(dof_guard=True),
    ],
)
def test_unported_solver_modes_raise(cfg):
    args, kw = _args(tau=0.0, iterations=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trl.richardson_lucy_MM(*args, config=trl.RLConfig(**cfg), device="cpu", **kw)
