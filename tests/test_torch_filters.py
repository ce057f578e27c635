"""The port's filters, LAB conversions, TV denoise and windows against
``ics_tpu`` on the CPU, and the K6 twin against the JAX scan and the Pallas
kernel (interpret mode, as tests/test_pallas.py runs it).  The kernel itself
is held against its twin on a GPU by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ics_tpu.ops.windows as jwin
from ics_tpu.models.tv_denoise import tv_denoise as j_tv_denoise
from ics_tpu.ops.pallas_bilateral import bilateral_pallas
from ics_tpu.utils import color as jcolor
from ics_tpu.utils import filters as jfilt

import ics_tpu_torch.ops.windows as twin
from ics_tpu_torch.models.tv_denoise import tv_denoise
from ics_tpu_torch.ops import cuda_bilateral, cuda_conv
from ics_tpu_torch.ops.conv import pad_symmetric
from ics_tpu_torch.utils import color as tcolor
from ics_tpu_torch.utils import filters as tfilt

RNG = np.random.default_rng(97)
REL = 1e-5  # max |port - JAX| / max |JAX|: f32 sums and exp in another order


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture
def no_launches():
    cuda_bilateral.launches = cuda_conv.launches = 0
    yield
    # CPU tensors take the plain twins: no kernel may have been launched
    assert (cuda_bilateral.launches, cuda_conv.launches) == (0, 0)


BILATERAL_CASES = {
    # (shape, radius, std_i, std_s, value scale)
    "17x15 r3": ((17, 15), 3, 0.1, 2.0, 1.0),
    "40x33 r5 L-scale": ((40, 33), 5, 5.0, 5.0, 100.0),
    "4x6 r4, smaller than 2r+1": ((4, 6), 4, 0.1, 2.0, 1.0),
}


@pytest.mark.parametrize("name", list(BILATERAL_CASES))
def test_k6_twin_and_bilateral_filter_match_jax(name, no_launches):
    shape, radius, std_i, std_s, scale = BILATERAL_CASES[name]
    src = (RNG.random(shape) * scale).astype(np.float32)
    scan = np.asarray(jfilt.bilateral_filter(src, radius, std_i, std_s))
    pallas = np.asarray(
        bilateral_pallas(src, radius, std_i, std_s, tile_h=16, interpret=True)
    )
    twin = cuda_bilateral.bilateral_planar_plain(torch.from_numpy(src)[None], radius,
                                                 std_i, std_s)[0]
    got = tfilt.bilateral_filter(src, radius, std_i, std_s, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), twin.numpy())
    assert _rel_err(twin, scan) <= REL
    assert _rel_err(twin, pallas) <= REL


def test_k6_twin_filters_each_plane_on_its_own(no_launches):
    src = RNG.random((3, 21, 19)).astype(np.float32)
    planes = torch.from_numpy(src)
    stacked = cuda_bilateral.bilateral_planar(planes, 2, 0.2, 3.0)
    for c in range(3):
        one = cuda_bilateral.bilateral_planar(planes[c : c + 1].contiguous(), 2, 0.2, 3.0)
        np.testing.assert_array_equal(stacked[c].numpy(), one[0].numpy())


@pytest.mark.parametrize("rows,cols", [((3, 3), (3, 3)), ((2, 1), (0, 4)), ((9, 7), (11, 5))])
def test_pad_symmetric_is_numpy_symmetric(rows, cols):
    a = RNG.random((2, 4, 3)).astype(np.float32)
    want = np.pad(a, ((0, 0), rows, cols), mode="symmetric")
    np.testing.assert_array_equal(pad_symmetric(torch.from_numpy(a), rows, cols).numpy(), want)


def test_bilateral_wrapper_contracts():
    with pytest.raises(ValueError, match="2-D"):
        tfilt.bilateral_filter(np.zeros((2, 3, 3), np.float32), 1, 0.1, 1.0, device="cpu")
    with pytest.raises(ValueError, match="radius"):
        cuda_bilateral.bilateral_planar(torch.zeros((1, 3, 3)), -1, 0.1, 1.0)
    with pytest.raises(TypeError, match="float32"):
        cuda_bilateral.bilateral_planar(torch.zeros((1, 3, 3), dtype=torch.float64), 1, 0.1, 1.0)


@pytest.mark.parametrize("luminance_only", [True, False])
def test_bilateral_lab_matches_jax(luminance_only, no_launches):
    rgb = RNG.random((23, 19, 3)).astype(np.float32)
    want = np.asarray(jfilt.bilateral_lab(rgb, 2, 5.0, 3.0, luminance_only=luminance_only))
    got = tfilt.bilateral_lab(rgb, 2, 5.0, 3.0, luminance_only=luminance_only, device="cpu")
    assert tuple(got.shape) == rgb.shape
    # sRGB in [0, 1]: pow, cube root and the 3x3 products round differently
    assert np.abs(got.numpy() - want).max() <= 2e-5


def test_lab_conversions_match_jax():
    rgb = RNG.random((31, 17, 3)).astype(np.float32)
    rgb[0, :4] = [[0, 0, 0], [1, 1, 1], [0.01, 0.002, 0.0], [1, 0, 0]]  # both branches
    jlab = jcolor.rgb_to_lab(jnp.asarray(rgb))
    tlab = tcolor.rgb_to_lab(torch.from_numpy(rgb))
    for ch in "LAB":
        # L in 0-100, A and B up to about +-100
        assert np.abs(getattr(tlab, ch).numpy() - np.asarray(getattr(jlab, ch))).max() <= 1e-3
    back = tcolor.lab_to_rgb(tlab).numpy()
    want = np.asarray(jcolor.lab_to_rgb(jlab))
    assert np.abs(back - want).max() <= 2e-5
    assert np.abs(back - rgb).max() <= 1e-4  # the round trip


@pytest.mark.parametrize("blur,kw", [
    ("gaussian_blur", dict(radius=5, amount=1.5)),
    ("bessel_blur", dict(radius=5, amount=8.0)),
    ("bessel_blur", dict(radius=4, amount=3.0)),  # even window: ceil/floor pads
])
def test_blurs_match_jax(blur, kw):
    src = RNG.random((29, 37)).astype(np.float32)
    want = np.asarray(getattr(jfilt, blur)(src, **kw))
    got = getattr(tfilt, blur)(src, **kw, device="cpu")
    assert tuple(got.shape) == src.shape
    assert _rel_err(got, want) <= REL


@pytest.mark.parametrize("method", ["bessel", "gauss"])
def test_usm_matches_jax(method):
    src = RNG.random((33, 26)).astype(np.float32)
    want = np.asarray(jfilt.USM(src, 5, 8.0, 1.0, method=method))
    got = tfilt.USM(src, 5, 8.0, 1.0, method=method, device="cpu")
    assert _rel_err(got, want) <= REL


def test_overlay_and_blending_match_jax():
    up = (RNG.random((15, 13)) * 100).astype(np.float32)
    lo = (RNG.random((15, 13)) * 100).astype(np.float32)
    lo[0, :3] = 50.0  # the exclusive masks zero these out
    want = np.asarray(jfilt.overlay(up, lo))
    for got in (tfilt.overlay(up, lo, device="cpu"),
                tfilt.blending(up, lo, "overlay", device="cpu")):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    assert np.all(got.numpy()[0, :3] == 0.0)


@pytest.mark.parametrize("domain", ["valid", "same", "full"])
@pytest.mark.parametrize("rgb", [False, True])
def test_convolve_matches_jax(domain, rgb):
    shape, kshape = ((21, 18, 3), (5, 4, 3)) if rgb else ((21, 18), (5, 4))
    a = RNG.standard_normal(shape).astype(np.float32)
    b = RNG.standard_normal(kshape).astype(np.float32)
    want = np.asarray(jfilt.convolve(a, b, domain))
    got = tfilt.convolve(a, b, domain, device="cpu")
    assert tuple(got.shape) == want.shape
    assert _rel_err(got, want) <= REL


def test_convolve_rejects_unknown_domain():
    with pytest.raises(ValueError, match="domain"):
        tfilt.convolve(np.zeros((4, 4)), np.ones((2, 2)), "circular", device="cpu")


@pytest.mark.parametrize("shape", [(19, 23), (19, 23, 3)])
def test_tv_denoise_matches_jax(shape):
    image = RNG.random(shape).astype(np.float32)
    want = np.asarray(j_tv_denoise(image, weight=0.1, iterations=20))
    got = tv_denoise(image, weight=0.1, iterations=20, device="cpu")
    assert tuple(got.shape) == shape
    assert np.abs(got.numpy() - want).max() <= 1e-5


@pytest.mark.parametrize("name,args", [
    ("uniform_kernel", (5,)),
    ("gaussian_kernel", (7, 1.5)),
    ("kaiser_kernel", (5, 8.0)),
    ("poisson_kernel", (6, 2.0)),
    ("disc_blur", (9.0,)),
    ("lens_blur", (9.0,)),
    ("motion_kernel", (9, 30.0)),
])
def test_windows_equal_jax(name, args):
    np.testing.assert_array_equal(np.asarray(getattr(twin, name)(*args)),
                                  np.asarray(getattr(jwin, name)(*args)))


def test_gaussian_weight_equals_jax():
    x = RNG.random(11)
    np.testing.assert_array_equal(twin.gaussian_weight(x, 0.5, 0.2),
                                  jwin.gaussian_weight(x, 0.5, 0.2))


def test_filters_need_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tfilt.bilateral_filter(np.zeros((4, 4), np.float32), 1, 0.1, 1.0)
