"""The port's TV-PAM and TV-PD solvers against ``ics_tpu``'s on the CPU,
and the behaviour checks of tests/test_solver_variants.py on the port."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

from ics_tpu.models import rl_pam as jpam
from ics_tpu.models import rl_pd as jpd
from ics_tpu.ops.conv import convolve_rgb
from ics_tpu.ops.psf import rotate_180
from ics_tpu.ops.reductions import whiteness_weights
from ics_tpu.ops.windows import gaussian_kernel

from ics_tpu_torch.models import rl_pam as tpam
from ics_tpu_torch.models import rl_pd as tpd
from ics_tpu_torch.ops.cuda_correlate import psf_gradient_planar
from ics_tpu_torch.ops.tv import tv_op

RNG = np.random.default_rng(43)
MK, M = 5, 41
PAD = MK // 2
WIN = dict(top=PAD + 1, bottom=M - PAD - 1, left=PAD + 1, right=M - PAD - 1)
WEIGHTS = whiteness_weights(WIN["bottom"] - WIN["top"], WIN["right"] - WIN["left"])
# u: five inner iterations per outer in another f32 summation order
TOL = {"u": 5e-5, "psf": 1e-6, "stats": 1e-6}


def _problem():
    base = RNG.random((M + 8, M + 8, 3)).astype(np.float32)
    k = gaussian_kernel(7, 1.5)
    smooth = np.stack(
        [sig.convolve(base[..., c], k, mode="valid") for c in range(3)], axis=-1
    )[:M, :M]
    image = np.clip(smooth, 0.2, 0.8).astype(np.float32)
    u = np.pad(image, ((PAD, PAD), (PAD, PAD), (0, 0)), mode="edge").astype(np.float32)
    psf = np.dstack([gaussian_kernel(MK, 1.0)] * 3).astype(np.float32)
    return image, u, psf


IMAGE, U, PSF = _problem()


def _planar(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(2, 0, 1).contiguous()


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, err_msg=what)


@pytest.mark.parametrize("blind,corr", [(False, False), (True, False), (True, True)])
def test_solve_pam_fixed_outer_count_matches_jax(blind, corr):
    kw = dict(**WIN, tau=0.0, step_factor=1e-3, lambda_tv=2e-3, epsilon=1e-3, iterations=5,
              blind=blind, correlation=corr, use_stopping=False)
    want = jpam._solve_pam(jnp.asarray(IMAGE), jnp.asarray(U), jnp.asarray(PSF),
                           jnp.asarray(WEIGHTS), conv_method="auto", **kw)
    u, psf, stats = tpam._solve_pam(torch.from_numpy(IMAGE), torch.from_numpy(U),
                                    torch.from_numpy(PSF), WEIGHTS, **kw)
    _close(u, want[0], TOL["u"], "u")
    _close(psf, want[1], TOL["psf"], "psf")
    _close(stats, np.array([float(want[2]), float(want[3]), *map(float, want[4:])]),
           TOL["stats"], "stats")


@pytest.mark.parametrize("edgetaper", [True, False])
@pytest.mark.parametrize("blind,corr", [(False, False), (True, False), (True, True)])
def test_solve_pd_fixed_outer_count_matches_jax(blind, corr, edgetaper):
    kw = dict(**WIN, tau_stop=0.0, step_factor=1e-3, lambda_tv=1e-4, sigma=0.05, tau=0.05,
              theta=1.0, iterations=5, blind=blind, correlation=corr, use_stopping=False,
              edgetaper=edgetaper)
    want = jpd._solve_pd(jnp.asarray(IMAGE), jnp.asarray(IMAGE), jnp.asarray(PSF),
                         jnp.asarray(WEIGHTS), **kw)
    u, psf, stats = tpd._solve_pd(_planar(IMAGE), _planar(IMAGE), _planar(PSF), WEIGHTS, **kw)
    _close(u.permute(1, 2, 0), want[0], TOL["u"], "u")
    _close(psf.permute(1, 2, 0), want[1], TOL["psf"], "psf")
    _close(stats, np.array([float(want[2]), float(want[3]), *map(float, want[4:])]),
           TOL["stats"], "stats")


def _both(name, *, blind, tau, iterations, config=None, **kw):
    jfn = {"pam": jpam.richardson_lucy_PAM, "pd": jpd.richardson_lucy_PD}[name]
    tfn = {"pam": tpam.richardson_lucy_PAM, "pd": tpd.richardson_lucy_PD}[name]
    args = (IMAGE, U, PSF, *WIN.values(), tau)
    kw = dict(iterations=iterations, blind=blind, **kw)
    jcfg = tcfg = None
    if config is not None:
        jcfg = {"pam": jpam.PAMConfig, "pd": jpd.PDConfig}[name](**config)
        tcfg = {"pam": tpam.PAMConfig, "pd": tpd.PDConfig}[name](**config)
    return jfn(*args, config=jcfg, **kw), tfn(*args, config=tcfg, device="cpu", **kw)


@pytest.mark.parametrize("name", ["pam", "pd"])
@pytest.mark.parametrize("blind,tau,iterations", [(False, 0.0, 40), (True, 0.0, 8),
                                                  (False, 1e9, 6)])
def test_richardson_lucy_whiteness_stop_matches_jax(name, blind, tau, iterations):
    """The stop on: the same outer count, verdict and stats.  tau = 0 makes
    the non-blind stop fire as soon as M_r rises.  The stats are reductions
    in another order, M_r the most sensitive (about 1e-4 relative after 12
    blind PD outers)."""
    a, b = _both(name, blind=blind, tau=tau, iterations=iterations)
    assert (b.iterations, b.converged) == (a.iterations, a.converged)
    np.testing.assert_allclose(b.stats.numpy(), np.asarray(a.stats), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), atol=TOL["u"])
    np.testing.assert_allclose(b.psf.numpy(), np.asarray(a.psf), atol=TOL["psf"])
    assert b.u_full is None and b.u.shape == IMAGE.shape
    np.testing.assert_array_equal(b.image.numpy(), IMAGE)


@pytest.mark.parametrize("name,config", [
    ("pam", dict(lambda_tv=1e-4, epsilon=1e-2)),
    ("pd", dict(lambda_tv=5e-3, sigma=0.1, tau=0.1, theta=0.5, edgetaper=False)),
])
def test_config_reaches_the_solver_like_jax(name, config):
    a, b = _both(name, blind=True, tau=0.0, iterations=4, config=config, correlation=True)
    assert b.iterations == a.iterations
    np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), atol=TOL["u"])
    np.testing.assert_allclose(b.psf.numpy(), np.asarray(a.psf), atol=TOL["psf"])


@pytest.mark.parametrize("port,jax_cls", [(tpam.PAMConfig, jpam.PAMConfig),
                                          (tpd.PDConfig, jpd.PDConfig)])
def test_configs_have_the_jax_fields_and_defaults(port, jax_cls):
    assert [(f.name, f.default) for f in dataclasses.fields(port)] == [
        (f.name, f.default) for f in dataclasses.fields(jax_cls)]
    assert port.__dataclass_params__.frozen


def test_pam_conv_method_other_than_auto_raises():
    with pytest.raises(NotImplementedError, match="conv_method"):
        tpam.richardson_lucy_PAM(IMAGE, U, PSF, *WIN.values(), 0.0, iterations=1,
                                 config=tpam.PAMConfig(conv_method="fft"), device="cpu")


@pytest.mark.parametrize("name", ["pam", "pd"])
def test_inputs_not_mutated(name):
    u, image = U.copy(), IMAGE.copy()
    fn = {"pam": tpam.richardson_lucy_PAM, "pd": tpd.richardson_lucy_PD}[name]
    fn(image, u, PSF, *WIN.values(), 0.0, iterations=2, device="cpu")
    np.testing.assert_array_equal(u, U)
    np.testing.assert_array_equal(image, IMAGE)


def test_pd_crops_a_padded_start_to_the_image():
    args = (PSF, *WIN.values(), 0.0)
    a = tpd.richardson_lucy_PD(IMAGE, U, *args, iterations=3, device="cpu")
    b = tpd.richardson_lucy_PD(IMAGE, U[PAD:-PAD, PAD:-PAD], *args, iterations=3, device="cpu")
    assert torch.equal(a.u, b.u) and torch.equal(a.stats, b.stats)


@pytest.mark.parametrize("mk", [3, 4, 5, 6])
@pytest.mark.parametrize("shape", [(41, 41), (37, 50)])
def test_psf_otf_matches_jax(mk, shape):
    """Odd and even PSFs: the centre tap (mk-1)//2 lands on (0, 0)."""
    psf = RNG.random((mk, mk, 3)).astype(np.float32)
    want = np.asarray(jpd._psf_otf(jnp.asarray(psf), *shape))
    got = tpd._psf_otf(_planar(psf), *shape).permute(1, 2, 0).numpy()
    # two FFT libraries: within 1e-6 relative to the spectrum's peak
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("mk", [3, 5, 8])
@pytest.mark.parametrize("shape", [(41, 41), (37, 50)])
def test_edgetaper_matches_jax(mk, shape):
    image = RNG.random((*shape, 3)).astype(np.float32)
    psf = RNG.random((mk, mk, 3)).astype(np.float32)
    psf /= psf.sum(axis=(0, 1))
    want = np.asarray(jpd._edgetaper(jnp.asarray(image), jnp.asarray(psf),
                                     jpd._psf_otf(jnp.asarray(psf), *shape)))
    got = tpd._edgetaper(_planar(image), _planar(psf), tpd._psf_otf(_planar(psf), *shape))
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, atol=1e-6)
    # the interior, beyond the PSF's support from every border, is kept
    inner = np.s_[mk:-mk, mk:-mk]
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy()[inner], image[inner], atol=1e-6)


@pytest.mark.parametrize("shape", [(9, 12, 3), (16, 7, 2)])
def test_grad_and_div_match_jax(shape):
    u = RNG.standard_normal(shape).astype(np.float32)
    q = RNG.standard_normal(shape).astype(np.float32)
    for got, want in zip(tpd._grad(_planar(u)), jpd._grad(jnp.asarray(u))):
        np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), np.asarray(want), atol=1e-6)
    got = tpd._div(_planar(u), _planar(q)).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, np.asarray(jpd._div(jnp.asarray(u), jnp.asarray(q))),
                               atol=1e-6)
    # -div is the adjoint of grad: <grad u, (p, q)> = <u, -div(p, q)>
    gy, gx = tpd._grad(_planar(u).double())
    lhs = float(torch.sum(gy * _planar(q).double()) + torch.sum(gx * _planar(u).double()))
    rhs = float(-torch.sum(_planar(u).double() * tpd._div(_planar(q).double(),
                                                          _planar(u).double())))
    assert abs(lhs - rhs) <= 1e-9 * max(1.0, abs(lhs))


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("mk", [3, 5, 7])
def test_blind_psf_gradient_route_is_jax_conv_of_rot180(mk, wrap):
    """The K3 route computes the JAX solvers' conv(rot180(u), error,
    'valid') (rl_pam.py:117-118; PD's on the wrap-padded u, rl_pd.py:223-230)
    within 1e-6 of JAX's direct convolution; JAX's 'auto' route, its FFT
    backend, is within 1e-4 of the peak."""
    p = mk // 2
    u = RNG.random((30, 34, 3)).astype(np.float32)
    u = np.pad(u, ((p, p), (p, p), (0, 0)), mode="wrap" if wrap else "edge")
    err = (0.01 * RNG.standard_normal((30, 34, 3))).astype(np.float32)
    u_rot = rotate_180(jnp.asarray(u))
    want = np.asarray(convolve_rgb(u_rot, jnp.asarray(err), mode="valid", method="direct"))
    got = psf_gradient_planar(_planar(u), _planar(err)).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    auto = np.asarray(convolve_rgb(u_rot, jnp.asarray(err), mode="valid"))
    np.testing.assert_allclose(got, auto, atol=1e-4 * np.abs(auto).max())


# -- the behaviour checks of tests/test_solver_variants.py, on the port ----


def _blurred_problem(mk=7, m=49):
    rng = np.random.default_rng(41)
    pad = mk // 2
    sharp = rng.random((m, m, 3)).astype(np.float32)
    smooth_k = gaussian_kernel(9, 2.0)
    sharp = np.stack(
        [sig.convolve(sharp[..., c], smooth_k, mode="same") for c in range(3)], axis=-1
    )
    sharp = np.clip(sharp, 0.1, 0.9).astype(np.float32)
    k = gaussian_kernel(mk, 1.2).astype(np.float32)
    padded = np.pad(sharp, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    blurry = np.stack(
        [sig.convolve(padded[..., c], k, mode="valid") for c in range(3)], axis=-1
    ).astype(np.float32)
    psf = np.dstack([k] * 3).astype(np.float32)
    u0 = np.pad(blurry, ((pad, pad), (pad, pad), (0, 0)), mode="edge").astype(np.float32)
    return sharp, blurry, u0, psf, pad


def test_pam_nonblind_improves():
    sharp, blurry, u0, psf, pad = _blurred_problem()
    m = blurry.shape[0]
    res = tpam.richardson_lucy_PAM(
        blurry, u0, psf, pad + 1, m - pad - 1, pad + 1, m - pad - 1,
        tau=1.0, iterations=30, step_factor=5e-3, blind=False,
        config=tpam.PAMConfig(lambda_tv=1e-4), device="cpu",
    )
    out = res.u.numpy()
    assert np.isfinite(out).all()
    assert np.mean((out - sharp) ** 2) < np.mean((blurry - sharp) ** 2)


@pytest.mark.parametrize("name", ["pam", "pd"])
def test_blind_runs_and_keeps_psf_normalized(name):
    sharp, blurry, u0, psf, pad = _blurred_problem(mk=5)
    m = blurry.shape[0]
    fn = {"pam": tpam.richardson_lucy_PAM, "pd": tpd.richardson_lucy_PD}[name]
    res = fn(blurry, u0, psf, pad + 1, m - pad - 1, pad + 1, m - pad - 1,
             tau=0.0, iterations=4, step_factor=1e-3, blind=True, device="cpu")
    psf_out = res.psf.numpy()
    assert np.isfinite(res.u.numpy()).all() and np.isfinite(psf_out).all()
    assert (psf_out >= 0).all()
    np.testing.assert_allclose(psf_out.sum(axis=(0, 1)), [1, 1, 1], rtol=1e-4)


def test_pd_nonblind_improves():
    sharp, blurry, u0, psf, pad = _blurred_problem()
    m = blurry.shape[0]
    res = tpd.richardson_lucy_PD(
        blurry, u0, psf, pad + 1, m - pad - 1, pad + 1, m - pad - 1,
        tau=1.0, iterations=30, blind=False, config=tpd.PDConfig(lambda_tv=1e-4),
        device="cpu",
    )
    out = res.u.numpy()
    assert out.shape == blurry.shape and np.isfinite(out).all()
    assert np.mean((out - sharp) ** 2) < np.mean((blurry - sharp) ** 2)


def test_pd_denoise_reduces_tv():
    """With an identity PSF, PD is TV denoising: TV drops, fidelity holds."""
    rng = np.random.default_rng(42)
    clean, _, _, _, _ = _blurred_problem()
    noisy = np.clip(clean + rng.normal(0, 0.05, clean.shape), 0.01, 0.99).astype(np.float32)
    ident = np.zeros((5, 5, 3), np.float32)
    ident[2, 2, :] = 1.0
    m = noisy.shape[0]
    res = tpd.richardson_lucy_PD(
        noisy, noisy.copy(), ident, 3, m - 3, 3, m - 3,
        tau=1.0, iterations=20, blind=False, config=tpd.PDConfig(lambda_tv=5e-2),
        device="cpu",
    )
    tv_in, _ = tv_op(torch.from_numpy(noisy), 1e-6)
    tv_out, _ = tv_op(res.u, 1e-6)
    assert float(torch.sum(tv_out)) < float(torch.sum(tv_in))
    assert np.mean((res.u.numpy() - clean) ** 2) < np.mean((noisy - clean) ** 2)


@pytest.mark.parametrize("name", ["pam", "pd"])
def test_bitwise_reproducible_on_cpu(name):
    fn = {"pam": tpam.richardson_lucy_PAM, "pd": tpd.richardson_lucy_PD}[name]
    a, b = (fn(IMAGE, U, PSF, *WIN.values(), 0.0, iterations=3, device="cpu") for _ in "ab")
    assert torch.equal(a.u, b.u) and torch.equal(a.psf, b.psf) and torch.equal(a.stats, b.stats)


@pytest.mark.parametrize("name", ["pam", "pd"])
def test_cuda_is_the_default_device(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    fn = {"pam": tpam.richardson_lucy_PAM, "pd": tpd.richardson_lucy_PD}[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(IMAGE, U, PSF, *WIN.values(), 0.0, iterations=1)


@pytest.mark.parametrize("name,outers", [("pam", 9), ("pd", 13)])
def test_blind_whiteness_stop_fires_like_jax(name, outers):
    """A blind solve stops on the first rise of M_r after the third outer,
    at the same outer as JAX; over 13 blind PD outers the PSF drifts to a
    few e-6 of JAX's (another f32 summation order in the FFTs)."""
    a, b = _both(name, blind=True, tau=0.0, iterations=30)
    assert (b.iterations, b.converged) == (a.iterations, a.converged) == (outers, True)
    np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), atol=TOL["u"])
    np.testing.assert_allclose(b.psf.numpy(), np.asarray(a.psf), atol=5e-6)
