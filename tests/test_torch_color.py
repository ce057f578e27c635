"""The port's colour operators against ``ics_tpu.utils.color`` on the CPU."""

import numpy as np
import pytest
import torch

import ics_tpu.utils as jutils
from ics_tpu.utils import color as jc

import ics_tpu_torch.utils as tutils
from ics_tpu_torch.utils import color as tc

RNG = np.random.default_rng(71)
RGB = RNG.random((21, 26, 3)).astype(np.float32)


def _close(got, want, tol=1e-6, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=rtol)


def _close_to_peak(got, want, tol=1e-5):
    """Within ``tol`` of the array's peak: the LAB-space operators scale A
    and B by a ratio of curves whose f32 rounding differs by an ulp."""
    want = np.asarray(want)
    _close(got, want, tol=tol * np.abs(want).max())


def _lab():
    lab = jc.rgb_to_lab(RGB)
    as_t = lambda a: torch.from_numpy(np.array(a))
    return lab, tc.LABImage(L=as_t(lab.L), A=as_t(lab.A), B=as_t(lab.B))


def test_rgb_to_hsv_matches_jax():
    grey = np.repeat(RGB[..., :1], 3, axis=-1)  # delta 0: hue and saturation 0
    for rgb in (RGB, grey, np.zeros((4, 4, 3), np.float32)):
        _close(tc.rgb_to_hsv(rgb, device="cpu"), jc.rgb_to_hsv(rgb))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.3, 1.4)])
def test_hsv_to_rgb_matches_jax(lo, hi):
    """Hues outside [0, 1] wrap to the sector of their floor mod 6."""
    hsv = (lo + (hi - lo) * RNG.random((17, 19, 3))).astype(np.float32)
    _close(tc.hsv_to_rgb(hsv, device="cpu"), jc.hsv_to_rgb(hsv))


def test_hsv_round_trip():
    _close(tc.hsv_to_rgb(tc.rgb_to_hsv(RGB, device="cpu")), RGB, tol=1e-6)


@pytest.mark.parametrize("amount", [20.0, 50.0, 80.0])
def test_grey_point_matches_jax(amount):
    lab, tlab = _lab()
    want, got = jc.grey_point(lab, amount), tc.grey_point(tlab, amount)
    for name in ("L", "A", "B"):
        _close_to_peak(getattr(got, name), getattr(want, name))


def test_auto_vibrance_matches_jax():
    lab, tlab = _lab()
    want, got = jc.auto_vibrance(lab), tc.auto_vibrance(tlab)
    _close_to_peak(got.A, want.A)
    _close_to_peak(got.B, want.B)
    assert got.L is tlab.L
    # beyond the spline's data range: end-segment extrapolation
    wide = tc.LABImage(L=tlab.L, A=tlab.A * 1.6, B=tlab.B - 90.0)
    want = jc.auto_vibrance(jc.LABImage(L=lab.L, A=np.asarray(lab.A) * 1.6,
                                        B=np.asarray(lab.B) - 90.0))
    got = tc.auto_vibrance(wide)
    _close_to_peak(got.A, want.A)
    _close_to_peak(got.B, want.B)


@pytest.mark.parametrize("image", [RGB, RGB[..., 0]], ids=["rgb", "plane"])
def test_divtv_matches_jax(image):
    _close(tc.divTV(image, device="cpu"), jc.divTV(image))


@pytest.mark.parametrize("kw", [{}, dict(epsilon=1e-2, tau=0.5, p=1.0)])
@pytest.mark.parametrize("image", [RGB, RGB[..., 1]], ids=["rgb", "plane"])
def test_gradtvem_matches_jax(image, kw):
    ut = np.clip(image + 0.05 * RNG.standard_normal(image.shape), 0, 1).astype(np.float32)
    _close(tc.gradTVEM(image, ut, **kw, device="cpu"), jc.gradTVEM(image, ut, **kw),
           tol=1e-6, rtol=1e-6)


def test_hue_angle_maps_match_jax():
    theta = RNG.random(64).astype(np.float32)
    _close(tc.normal2rad(theta, device="cpu"), jc.normal2rad(theta))
    rad = (theta * 2 * np.pi - np.pi).astype(np.float32)
    _close(tc.rad2normal(rad, device="cpu"), jc.rad2normal(rad))


@pytest.mark.parametrize("target,amount", [(1.0, 0.5), (-2.0, 1.5), (0.3, 0.0)])
def test_hue_shift_matches_jax(target, amount):
    src = (RNG.random(50) * 2 * np.pi - np.pi).astype(np.float32)
    _close(tc.hue_shift(src, target, amount, device="cpu"), jc.hue_shift(src, target, amount))


@pytest.mark.parametrize("amount", [0.3, -0.2, 0.0])
def test_saturation_boost_matches_jax(amount):
    sat = RNG.random((9, 11)).astype(np.float32)
    _close(tc.saturation_boost(sat, amount, device="cpu"), jc.saturation_boost(sat, amount))


@pytest.mark.parametrize("sigma", [1.0 / 8.0, 0.3])
def test_luma_masks_match_jax(sigma):
    lum = RNG.random((15, 13)).astype(np.float32)
    got, want = tc.luma_masks(lum, sigma, device="cpu"), jc.luma_masks(lum, sigma)
    for g, w in zip(got, want):
        _close(g, w)
    _close(sum(got), np.ones_like(lum))


def test_lagrange_interpolation_matches_jax():
    points = np.array([[0.0, 1.0], [30.0, 25.0], [70.0, 60.0], [100.0, 100.0]])
    x = np.linspace(0.0, 100.0, 11)
    (p1, y1), (p2, y2) = tc.Lagrange_interpolation(points, x), jc.Lagrange_interpolation(points, x)
    np.testing.assert_array_equal(p1.coeffs, p2.coeffs)
    np.testing.assert_array_equal(y1, y2)
    assert tc.Lagrange_interpolation(points)[1] is None


def test_operators_keep_the_input_device_and_float32():
    t = torch.from_numpy(RGB.astype(np.float64))
    for out in (tc.rgb_to_hsv(t), tc.hsv_to_rgb(t), tc.divTV(t), tc.gradTVEM(t, t)):
        assert out.dtype == torch.float32 and out.device == t.device


def test_lab_operators_take_numpy_on_the_requested_device():
    lab = jc.rgb_to_lab(RGB)
    for op in (lambda d: tc.grey_point(lab, 50.0, device=d),
               lambda d: tc.auto_vibrance(lab, device=d)):
        got = op("cpu")
        assert got.A.dtype == torch.float32 and got.A.device.type == "cpu"
        assert got.B.device.type == "cpu"


def test_cuda_is_the_default_device_for_host_inputs():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    lab = jc.rgb_to_lab(RGB)
    lum = RGB[..., 0]
    for op in (lambda: tc.grey_point(lab, 50.0), lambda: tc.auto_vibrance(lab),
               lambda: tc.divTV(RGB), lambda: tc.gradTVEM(RGB, RGB), lambda: tc.rgb_to_hsv(RGB),
               lambda: tc.hsv_to_rgb(RGB), lambda: tc.normal2rad(lum),
               lambda: tc.rad2normal(lum), lambda: tc.hue_shift(lum, 1.0, 0.5),
               lambda: tc.saturation_boost(lum, 0.3), lambda: tc.luma_masks(lum)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            op()


def test_utils_exports_the_jax_names():
    jax_names = set(jutils.__all__) - {"enable_persistent_cache"}
    assert jax_names <= set(tutils.__all__)
    for name in jax_names:
        assert callable(getattr(tutils, name)) or isinstance(getattr(tutils, name), type)
