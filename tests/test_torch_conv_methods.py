"""The port's explicit convolution methods (``ops/conv.py`` ``method=`` and
``precision=``, ``cuda_conv_mma.conv_rgb_mxu``) and the solvers'
``conv_method`` against the JAX package on the CPU, where every method runs
its plain twin (JAX's Pallas kernels run in interpret mode, as
tests/test_conv.py runs them).

Tolerances, relative to the largest value of the JAX output:

* 1e-5: the float32 methods at exact precision (HIGHEST), and at
  ``bf16x3`` under the explicit methods, which run HIGHEST for it in both
  packages: the same f32 function, summed in other orders;
* 1e-4: ``conv_rgb_mxu`` at ``bf16x3`` (the split kernel's twin against
  JAX's split kernel);
* 2e-2: bfloat16 operands (the JAX selftest's bound: JAX's stencil and VPU
  kernel round their partial sums to bf16, the port's K4 once);
* 1e-2: K4d's twin against JAX at DEFAULT: JAX on the CPU computes DEFAULT
  in f32, while the MXU, and the port, round the operands to bf16.  That
  twin is also held within 1e-6 of a float64 convolution of the
  bf16-rounded operands.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch
from jax import lax

from ics_tpu.models import rl_mm as jrl
from ics_tpu.models import rl_pam as jpam
from ics_tpu.ops import conv as jconv
from ics_tpu.ops.pallas_conv_mxu import conv_rgb_pallas_mxu
from ics_tpu.ops.windows import gaussian_kernel, uniform_kernel

from ics_tpu_torch.models import rl_mm as trl
from ics_tpu_torch.models import rl_pam as tpam
from ics_tpu_torch.ops import conv as tconv
from ics_tpu_torch.ops import cuda_conv, cuda_conv_mma
from ics_tpu_torch.utils import metrics

METHODS = ["auto", "stencil", "pallas", "pallas_mxu", "mxu", "direct", "fft"]
MODES = ["valid", "same", "full"]
JAX_PRECISION = {"exact": lax.Precision.HIGHEST, "bf16x3": "bf16x3",
                 "fast": lax.Precision.DEFAULT}


def _inputs(seed, shape=(40, 52, 3), mk=5, nk=7):
    rng = np.random.default_rng(seed)
    return (rng.random(shape).astype(np.float32),
            rng.random((mk, nk, shape[-1])).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture
def no_launches():
    """CPU tensors take the plain twins: no kernel is launched."""
    counters = ("split_launches", "bf16_launches", "highest_launches", "default_launches")
    before = (cuda_conv.launches, *(getattr(cuda_conv_mma, c) for c in counters))
    yield
    assert (cuda_conv.launches, *(getattr(cuda_conv_mma, c) for c in counters)) == before


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", METHODS)
def test_f32_methods_match_jax(method, mode, no_launches):
    a, k = _inputs(1)
    want = jconv.convolve_rgb(jnp.asarray(a), jnp.asarray(k), mode, method=method)
    got = tconv.convolve_rgb(torch.from_numpy(a), torch.from_numpy(k), mode, method=method)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("precision,tol", [("exact", 1e-5), ("bf16x3", 1e-5)])
@pytest.mark.parametrize("method", ["pallas_mxu", "mxu"])
def test_mxu_methods_match_jax_precisions(method, precision, tol, mode, no_launches):
    """9x9 taps: the K4h twin at 'exact' and at 'bf16x3' (which JAX's
    explicit methods, and the port's, run as HIGHEST) against JAX's MXU
    methods."""
    a, k = _inputs(2, mk=9, nk=9)
    want = jconv.convolve_rgb(jnp.asarray(a), jnp.asarray(k), mode, method=method,
                              precision=JAX_PRECISION[precision])
    got = tconv.convolve_rgb(torch.from_numpy(a), torch.from_numpy(k), mode, method=method,
                             precision=precision)
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("precision,tol", [("highest", 1e-5), ("bf16x3", 1e-4),
                                           ("default", 1e-2)])
def test_conv_rgb_mxu_matches_conv_rgb_pallas_mxu(precision, tol, mode, no_launches):
    """``conv_rgb_mxu`` against ``conv_rgb_pallas_mxu`` (its split kernel at
    'bf16x3'; at DEFAULT JAX's CPU computes f32, the port rounds to bf16)."""
    a, k = _inputs(3, mk=9, nk=7)
    jprec = {"highest": lax.Precision.HIGHEST, "bf16x3": "bf16x3",
             "default": lax.Precision.DEFAULT}[precision]
    want = conv_rgb_pallas_mxu(jnp.asarray(a), jnp.asarray(k), mode, precision=jprec,
                               interpret=True)
    got = cuda_conv_mma.conv_rgb_mxu(torch.from_numpy(a), torch.from_numpy(k), mode, precision)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= tol


def _bf16_reference(a, k, mode):
    """float64 convolution of the bf16-rounded operands, per channel."""
    ab = torch.from_numpy(a).bfloat16().double().numpy()
    kb = torch.from_numpy(k).bfloat16().double().numpy()
    return np.stack([sig.convolve(ab[..., c], kb[..., c], mode=mode)
                     for c in range(a.shape[-1])], axis=-1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mk,nk", [(3, 3), (5, 7), (9, 9)])
def test_k4d_twin_matches_jax_default_and_a_bf16_rounded_reference(mk, nk, mode, no_launches):
    a, k = _inputs(4, mk=mk, nk=nk)
    got = tconv.convolve_rgb(torch.from_numpy(a), torch.from_numpy(k), mode,
                             method="pallas_mxu", precision="fast")
    assert _rel(got, _bf16_reference(a, k, mode)) <= 1e-6
    want = jconv.convolve_rgb(jnp.asarray(a), jnp.asarray(k), mode, method="pallas_mxu",
                              precision=lax.Precision.DEFAULT)
    assert _rel(got, want) <= 1e-2
    # the planar wrapper and its twin: the same function
    planar = cuda_conv_mma.conv_default(torch.from_numpy(a).permute(2, 0, 1).contiguous(),
                                        torch.from_numpy(k).permute(2, 0, 1).contiguous(), mode)
    assert torch.equal(planar.permute(1, 2, 0), got)


@pytest.mark.parametrize("method", METHODS)
def test_bf16_operands_match_jax(method, no_launches):
    a, k = _inputs(5)
    want = jconv.convolve_rgb(jnp.asarray(a, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                              "same", method=method)
    got = tconv.convolve_rgb(torch.from_numpy(a).bfloat16(), torch.from_numpy(k).bfloat16(),
                             "same", method=method)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), np.asarray(want, np.float32)) <= 2e-2


@pytest.mark.parametrize("method", ["pallas_mxu", "pallas", "stencil"])
def test_taps_over_31_take_the_direct_route(method, no_launches):
    """33x35 taps: no kernel instance takes them; the direct convolution
    computes JAX's function (its Pallas kernel in interpret mode)."""
    a, k = _inputs(6, shape=(44, 50, 3), mk=33, nk=35)
    want = jconv.convolve_rgb(jnp.asarray(a), jnp.asarray(k), "same", method=method)
    got = tconv.convolve_rgb(torch.from_numpy(a), torch.from_numpy(k), "same", method=method)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("method", ["auto", "pallas_mxu", "direct", "fft"])
def test_convolve2d_methods_match_jax(method, no_launches):
    a, k = _inputs(7, shape=(33, 41, 1), mk=7, nk=5)
    a, k = a[..., 0], k[..., 0]
    want = jconv.convolve2d(jnp.asarray(a), jnp.asarray(k), "full", method=method)
    got = tconv.convolve2d(torch.from_numpy(a), torch.from_numpy(k), "full", method=method)
    assert _rel(got, want) <= 1e-5


def test_unknown_method_raises_as_jax_does():
    a, k = _inputs(8)
    with pytest.raises(ValueError, match="unknown method"):
        jconv.convolve_rgb(jnp.asarray(a), jnp.asarray(k), "same", method="bogus")
    with pytest.raises(ValueError, match="unknown method"):
        tconv.convolve_rgb(torch.from_numpy(a), torch.from_numpy(k), "same", method="bogus")
    with pytest.raises(ValueError, match="unknown precision"):
        tconv.convolve_rgb(torch.from_numpy(a), torch.from_numpy(k), "same", precision="bogus")


def test_pallas_mxu_width_over_129_raises_as_jax_does():
    a, k = _inputs(9, shape=(20, 140, 3), mk=3, nk=130)
    with pytest.raises(ValueError, match="129"):
        jconv.convolve_rgb(jnp.asarray(a), jnp.asarray(k), "same", method="pallas_mxu")
    with pytest.raises(ValueError, match="129"):
        tconv.convolve_rgb(torch.from_numpy(a), torch.from_numpy(k), "same",
                           method="pallas_mxu")
    with pytest.raises(ValueError, match="129"):
        cuda_conv_mma.conv_rgb_mxu(torch.from_numpy(a), torch.from_numpy(k))
    # 'mxu' takes the FFT there, as JAX's _conv_mxu does
    want = jconv.convolve_rgb(jnp.asarray(a), jnp.asarray(k), "same", method="mxu")
    got = tconv.convolve_rgb(torch.from_numpy(a), torch.from_numpy(k), "same", method="mxu")
    assert _rel(got, want) <= 1e-5


# ------------------------------------------------------------- the solvers
RNG = np.random.default_rng(49)
MK, M = 5, 41
PAD = MK // 2
WIN = (PAD + 1, M - PAD - 1, PAD + 1, M - PAD - 1)


def _problem():
    base = RNG.random((M + 8, M + 8, 3)).astype(np.float32)
    smooth = np.stack([sig.convolve(base[..., c], gaussian_kernel(7, 1.5), mode="valid")
                       for c in range(3)], axis=-1)[:M, :M]
    image = np.clip(smooth, 0.2, 0.8).astype(np.float32)
    u = np.pad(image, ((PAD, PAD), (PAD, PAD), (0, 0)), mode="edge").astype(np.float32)
    psf = np.dstack([uniform_kernel(MK)] * 3).astype(np.float32)
    return image, u, psf


IMAGE, U, PSF = _problem()


def _mm(blind, **cfg):
    """Three outers at a fixed count (tau = 1e9) of each package's solver."""
    kw = dict(tau=1e9, iterations=3, lambd=1000.0, blind=blind)
    want = jrl.richardson_lucy_MM(IMAGE, U, PSF, *WIN, config=jrl.RLConfig(**cfg), **kw)
    got = trl.richardson_lucy_MM(IMAGE, U, PSF, *WIN, config=trl.RLConfig(**cfg),
                                 device="cpu", **kw)
    assert got.iterations == want.iterations == 3
    return want, got


@pytest.mark.parametrize("blind", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_richardson_lucy_mm_conv_methods_match_jax(method, blind, no_launches):
    want, got = _mm(blind, conv_method=method)
    assert _rel(got.u, want.u) <= 1e-5
    assert _rel(got.psf, want.psf) <= 1e-5
    np.testing.assert_allclose(got.stats.numpy(), np.asarray(want.stats), rtol=1e-5)


@pytest.mark.parametrize("blind", [False, True])
def test_richardson_lucy_mm_pallas_mxu_high_matches_jax(blind, no_launches):
    """'high' + 'pallas_mxu': the port's K4h twin against JAX's HIGHEST."""
    want, got = _mm(blind, conv_method="pallas_mxu", conv_precision="high")
    assert _rel(got.u, want.u) <= 1e-5
    assert _rel(got.psf, want.psf) <= 1e-5


@pytest.mark.parametrize("blind", [False, True])
@pytest.mark.parametrize("method", ["pallas_mxu", "mxu"])
def test_richardson_lucy_mm_explicit_high_equals_exact(method, blind, no_launches):
    """Under an explicit method 'high' is 'exact' (JAX computes the two the
    same way): the port's two solves are equal bit for bit."""
    kw = dict(tau=1e9, iterations=3, lambd=1000.0, blind=blind, device="cpu")
    high, exact = (trl.richardson_lucy_MM(
        IMAGE, U, PSF, *WIN, config=trl.RLConfig(conv_method=method, conv_precision=p), **kw)
        for p in ("high", "exact"))
    assert torch.equal(high.u, exact.u) and torch.equal(high.psf, exact.psf)
    assert torch.equal(high.stats, exact.stats)


@pytest.mark.parametrize("blind", [False, True])
def test_richardson_lucy_mm_pallas_mxu_fast_ssim(blind, no_launches):
    """'fast' + 'pallas_mxu': bf16-rounded operands (K4d's twin) against
    JAX's f32 DEFAULT on the CPU: SSIM >= 0.99."""
    want, got = _mm(blind, conv_method="pallas_mxu", conv_precision="fast")
    assert metrics.ssim(got.u.numpy(), np.asarray(want.u), device="cpu") >= 0.99
    assert bool(torch.isfinite(got.psf).all())


@pytest.mark.parametrize("blind,method", [(False, "pallas_mxu"), (False, "direct"),
                                          (True, "direct")])
def test_richardson_lucy_pam_conv_method_matches_jax(blind, method, no_launches):
    kw = dict(tau=1e9, iterations=3, blind=blind)
    want = jpam.richardson_lucy_PAM(IMAGE, U, PSF, *WIN,
                                    config=jpam.PAMConfig(conv_method=method), **kw)
    got = tpam.richardson_lucy_PAM(IMAGE, U, PSF, *WIN,
                                   config=tpam.PAMConfig(conv_method=method), device="cpu",
                                   **kw)
    assert got.iterations == want.iterations == 3
    assert _rel(got.u, want.u) <= 1e-5
    assert _rel(got.psf, want.psf) <= 1e-5
