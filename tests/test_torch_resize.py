"""``utils/resize.py::resize_jax(method=)`` against the JAX package's
``resize_jax`` (``jax.image.resize`` under ``jax.jit``) on the CPU, for
every method name that ``jax.image.resize`` takes.

Tolerances, relative to the largest value of the JAX output:

* ``nearest`` is a gather: bitwise, in the input's dtype;
* 1e-6 for the other kernels: the port builds the same weights in float64,
  rounded once, and applies them as float32 matmuls;
* Lanczos: XLA's jitted float32 ``sin`` on the CPU moves JAX's own weights
  at some sample positions (the 37 -> 61 axis) by more than 1e-6 of the
  output, so there the port is held within 1e-6 of JAX's weights computed
  eagerly (``compute_weight_mat`` outside ``jit``) and applied in float64,
  and within 2e-6 of jitted JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jscale

from ics_tpu.utils.resize import resize_jax as jresize

from ics_tpu_torch.utils import resize as tresize

METHODS = ["nearest", "linear", "bilinear", "trilinear", "triangle", "cubic", "bicubic",
           "tricubic", "lanczos3", "lanczos5"]
# downscale and upscale, 2-D and three channels
CASES = [((37, 41), (20, 23)), ((37, 41), (61, 80)), ((29, 33, 3), (17, 52)),
         ((29, 33, 3), (58, 70))]
LANCZOS_RADIUS = {"lanczos3": 3.0, "lanczos5": 5.0}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _eager_lanczos(x: np.ndarray, out, radius: float) -> np.ndarray:
    """JAX's Lanczos weights from ``compute_weight_mat`` run eagerly (its
    float32 sample positions and kernel), applied in float64."""
    def weights(m, n):
        return np.asarray(jscale.compute_weight_mat(
            m, n, n / m, 0.0, lambda d: jscale._fill_lanczos_kernel(radius, d), True), np.float64)

    return np.einsum("hi,hw...,wj->ij...", weights(x.shape[0], out[0]), x.astype(np.float64),
                     weights(x.shape[1], out[1]))


@pytest.mark.parametrize("shape,out", CASES)
@pytest.mark.parametrize("method", METHODS)
def test_resize_jax_methods_match_jax(method, shape, out):
    x = np.random.default_rng(len(shape) * 100 + out[0]).random(shape).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(x), out, method=method))
    got = tresize.resize_jax(torch.from_numpy(x), out, method=method).numpy()
    assert got.shape == want.shape == out + shape[2:]
    assert got.dtype == want.dtype == np.float32
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    elif method in LANCZOS_RADIUS:
        assert _rel(got, _eager_lanczos(x, out, LANCZOS_RADIUS[method])) <= 1e-6
        assert _rel(got, want) <= 2e-6
    else:
        assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32, np.float32])
def test_resize_jax_nearest_keeps_the_dtype(dtype):
    x = (np.random.default_rng(3).random((23, 30, 3)) * 200).astype(dtype)
    for out in [(11, 47), (40, 13)]:
        want = np.asarray(jresize(jnp.asarray(x), out, method="nearest"))
        got = tresize.resize_jax(torch.from_numpy(x), out, method="nearest").numpy()
        assert got.dtype == want.dtype == dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["bogus", "Cubic", "lanczos4", "area"])
def test_resize_jax_unknown_method_raises(method):
    with pytest.raises(ValueError, match="Unknown resize method"):
        jresize(jnp.ones((8, 8)), (4, 4), method=method)
    with pytest.raises(ValueError, match="Unknown resize method"):
        tresize.resize_jax(torch.ones((8, 8)), (4, 4), method=method)


def test_the_default_method_is_the_pipelines_cubic():
    """The pipeline calls ``resize_jax(img, shape)``: the cubic, the same
    bits as naming it."""
    x = torch.from_numpy(np.random.default_rng(5).random((31, 44, 3)).astype(np.float32))
    assert torch.equal(tresize.resize_jax(x, (45, 30)), tresize.resize_jax(x, (45, 30), "cubic"))
    assert sorted(tresize.METHODS) == sorted(METHODS)
