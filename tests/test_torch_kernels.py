"""The plain twins of the port's CUDA kernels against the Pallas kernels
(interpret mode on the CPU, as tests/test_pallas.py runs them) and the
wrapper contracts.  The kernels themselves are held against their twins on
a GPU by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.ops.pallas_conv import conv_rgb_pallas
from ics_tpu.ops.pallas_correlate import correlate_psf_valid as j_corr_valid
from ics_tpu.ops.pallas_correlate import psf_gradient as j_psf_gradient
from ics_tpu.ops.pallas_solver import fits_vmem, inner_loop_pallas
from ics_tpu.ops.windows import uniform_kernel

from ics_tpu_torch.ops import cuda_conv, cuda_correlate, cuda_solver

RNG = np.random.default_rng(43)


def _planar(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 0)))


def _hwc(t):
    return np.moveaxis(t.numpy(), 0, -1)


@pytest.fixture
def zero_launches():
    mods = (cuda_conv, cuda_correlate, cuda_solver)
    for mod in mods:
        mod.launches = 0
    yield
    # CPU tensors take the plain twins: no kernel may have been launched
    assert [mod.launches for mod in mods] == [0, 0, 0]


@pytest.mark.parametrize("mode", ["valid", "same", "full"])
def test_k1_twin_matches_pallas_conv(mode, zero_launches):
    a = RNG.standard_normal((47, 39, 3)).astype(np.float32)
    k = RNG.standard_normal((7, 7, 3)).astype(np.float32)
    want = np.asarray(conv_rgb_pallas(a, jnp.asarray(k), mode, tile_h=16, interpret=True))
    got = _hwc(cuda_conv.conv_planar(_planar(a), _planar(k), mode))
    assert got.shape == want.shape
    # max error relative to the largest output (f32 sum orders differ)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_k3_twin_matches_pallas_psf_gradient(zero_launches):
    mk, m = 5, 43
    pad = mk // 2
    u = RNG.random((m + 2 * pad, m + 2 * pad, 3)).astype(np.float32)
    err = RNG.standard_normal((m, m, 3)).astype(np.float32)
    want = np.asarray(j_psf_gradient(jnp.asarray(u), jnp.asarray(err), tile_h=16, interpret=True))
    got = cuda_correlate.psf_gradient(torch.from_numpy(u), torch.from_numpy(err)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    want2 = np.asarray(j_corr_valid(jnp.asarray(u), jnp.asarray(err), tile_h=16, interpret=True))
    got2 = cuda_correlate.correlate_psf_valid(torch.from_numpy(u), torch.from_numpy(err)).numpy()
    assert np.abs(got2 - want2).max() <= 1e-5 * np.abs(want2).max()


@pytest.mark.parametrize("blind,corr", [(False, False), (True, False), (True, True)])
def test_k2_twin_matches_pallas_inner_loop(blind, corr, zero_launches):
    mk, m = 5, 31
    pad = mk // 2
    image = np.clip(RNG.random((m, m, 3)), 0.2, 0.8).astype(np.float32)
    u = np.pad(image, ((pad, pad), (pad, pad), (0, 0)), mode="edge").astype(np.float32)
    psf = np.dstack([uniform_kernel(mk)] * 3).astype(np.float32)
    kw = dict(step_factor=1e-3, lambd=1000.0, blind=blind, correlation=corr)
    ju, jpsf, jerr = inner_loop_pallas(
        jnp.asarray(u), jnp.asarray(image), jnp.asarray(psf), interpret=True, **kw
    )
    tu, tpsf, terr = cuda_solver.inner_loop_planar(_planar(u), _planar(image), _planar(psf), **kw)
    # the tolerances of tests/test_pallas.py:113-114 (five iterations of a
    # different f32 summation order)
    np.testing.assert_allclose(_hwc(tu), np.asarray(ju), atol=5e-5)
    np.testing.assert_allclose(_hwc(tpsf), np.asarray(jpsf), atol=1e-6)
    np.testing.assert_allclose(_hwc(terr), np.asarray(jerr), atol=5e-5)
    if corr:
        p = _hwc(tpsf)
        np.testing.assert_array_equal(p[..., 0], p[..., 1])


@pytest.mark.parametrize("side", [131, 185, 261, 262, 330, 331, 369, 520])
def test_k2_window_bound_is_the_jax_bound(side):
    assert cuda_solver.fits(side, side) == fits_vmem(side, side)


def test_wrappers_reject_bad_input():
    a = torch.zeros((3, 10, 10))
    with pytest.raises(TypeError, match="float32"):
        cuda_conv.conv_planar(a.double(), torch.zeros((3, 3, 3), dtype=torch.float64), "same")
    with pytest.raises(ValueError, match="unknown mode"):
        cuda_conv.conv_planar(a, torch.zeros((3, 3, 3)), "circular")
    with pytest.raises(ValueError, match="at least as large"):
        cuda_conv.conv_planar(a, torch.zeros((3, 11, 3)), "valid")
    with pytest.raises(ValueError, match="expected"):
        cuda_conv.conv_planar(a, torch.zeros((2, 3, 3)), "same")
    with pytest.raises(ValueError, match="at least as large"):
        cuda_correlate.psf_gradient_planar(torch.zeros((3, 5, 5)), torch.zeros((3, 6, 6)))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_conv.conv_planar(a.to("meta"), torch.zeros((3, 3, 3), device="meta"), "same")
