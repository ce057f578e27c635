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


# ---------------------------------------------------------------- the band tables
# The banded kernel (csrc/resize.cu, ops/cuda_resize.py) reads only each
# output's band of ``weight_matrix``: ``band_tables`` builds it by the same
# recipe, so scattered back it is the dense matrix, the same non-zeros and
# weights within 1 ulp (only the float64 sum's order differs).
from resize_cases import axes  # noqa: E402

from ics_tpu_torch.ops import cuda_resize  # noqa: E402

KERNEL_METHODS = [m for m in METHODS if m != "nearest"]
CASE_AXES = sorted({(shape[axis], out[axis]) for shape, out in CASES for axis in (0, 1)})
PSF_AXES = [(9, 7)]


def _scatter(start, count, band, in_size) -> torch.Tensor:
    dense = torch.zeros((in_size, band.shape[1]), dtype=torch.float32)
    for j, (s, n) in enumerate(zip(start.tolist(), count.tolist())):
        dense[s:s + n, j] = band[:n, j]
    return dense


def _assert_band_is_the_matrix(tables, dense: torch.Tensor) -> None:
    start, count, band = tables
    assert start.dtype == count.dtype == torch.int32 and band.dtype == torch.float32
    assert band.shape == (max(int(count.max()), 1), dense.shape[1]) and band.is_contiguous()
    assert int(count.min()) >= 0 and int((start + count).max()) <= dense.shape[0]
    got = _scatter(start, count, band, dense.shape[0])
    np.testing.assert_array_equal((got != 0).numpy(), (dense != 0).numpy())
    ulps = (got.view(torch.int32).long() - dense.view(torch.int32).long()).abs()
    assert int(ulps.max()) <= 1
    assert int((band[torch.arange(band.shape[0])[:, None] >= count[None, :]] != 0).sum()) == 0


@pytest.mark.parametrize("in_size,out_size", CASE_AXES + PSF_AXES)
@pytest.mark.parametrize("method", KERNEL_METHODS)
def test_band_tables_are_the_weight_matrix(method, in_size, out_size):
    _assert_band_is_the_matrix(tresize.band_tables(in_size, out_size, method),
                               tresize.weight_matrix(in_size, out_size, "cpu", method))


@pytest.mark.parametrize("in_size,out_size", axes())
def test_band_tables_are_the_weight_matrix_at_the_pipelines_shapes(in_size, out_size):
    """Both cells' axes, the 24 MP ones included: ``__wrapped__`` builds the
    dense matrix without keeping it in ``weight_matrix``'s cache."""
    _assert_band_is_the_matrix(tresize.band_tables(in_size, out_size),
                               tresize.weight_matrix.__wrapped__(in_size, out_size, "cpu"))


@pytest.mark.parametrize("method", ["cubic", "lanczos5"])
def test_an_output_sampled_outside_the_input_has_an_empty_band(method):
    """JAX gives an output whose sample point lies outside the input weight 0
    (``resize`` itself never samples there: translated samples do)."""
    in_size, kernel_scale = 12, 1.0
    sample_f = torch.tensor([-3.0, -0.75, -0.5, 0.0, 5.25, 11.5, 11.75, 15.0])
    start, count, band = tresize._bands(method, in_size, sample_f, kernel_scale)
    taps = torch.arange(in_size, dtype=torch.float32)[:, None]
    dense = tresize._weights(tresize._KERNELS[method], taps, sample_f, kernel_scale, in_size)
    assert count.tolist()[:2] == [0, 0] and count.tolist()[-2:] == [0, 0]
    assert all(n > 0 for n in count.tolist()[2:-2])
    _assert_band_is_the_matrix((start, count, band), dense)


def _banded(x: torch.Tensor, axis: int, out_size: int, method: str) -> torch.Tensor:
    """What the kernel computes, one tap at a time in ascending order, from
    the tables: out[o, j, b] = sum_t w[t, j] * x[o, start[j] + t, b]."""
    start, count, band = tresize.band_tables(x.shape[axis], out_size, method)
    view = x.reshape(int(np.prod(x.shape[:axis])), x.shape[axis], -1)
    out = torch.zeros((view.shape[0], out_size, view.shape[2]), dtype=torch.float32)
    for t in range(band.shape[0]):
        live = t < count
        rows = torch.where(live, start + t, torch.zeros_like(start)).long()
        out = torch.addcmul(out, band[t][None, :, None] * live[None, :, None],
                            view[:, rows, :])
    shape = list(x.shape)
    shape[axis] = out_size
    return out.reshape(shape)


@pytest.mark.parametrize("shape,out", CASES + [((9, 9, 3), (7, 7)), ((685, 697, 3), (969, 987))])
@pytest.mark.parametrize("method", KERNEL_METHODS)
def test_the_banded_sum_is_the_dense_twin(method, shape, out):
    """The kernel's sum over the tables against the dense twin, each pass on
    the same input, within 2e-7 of the largest value (the card's tolerance)."""
    x = torch.from_numpy(np.random.default_rng(shape[0] + out[1]).random(shape).astype(np.float32))
    for axis in (0, 1):
        want = cuda_resize.resample_plain(x, axis, out[axis], method)
        got = _banded(x, axis, out[axis], method)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 2e-7 * float(want.abs().max())
        x = want


def test_resample_on_the_cpu_is_the_dense_twin_and_launches_nothing():
    x = torch.from_numpy(np.random.default_rng(9).random((29, 33, 3)).astype(np.float32))
    before = cuda_resize.launches
    for axis, n in ((0, 17), (1, 52)):
        got = cuda_resize.resample(x, axis, n)
        w = tresize.weight_matrix(x.shape[axis], n, "cpu")
        want = ((w.T @ x.reshape(x.shape[0], -1)).reshape(n, *x.shape[1:]) if axis == 0
                else (x.movedim(1, -1) @ w).movedim(-1, 1))
        assert torch.equal(got, want)
    assert cuda_resize.launches == before
    assert torch.equal(tresize.resize_jax(x, (17, 52)),
                       cuda_resize.resample(cuda_resize.resample(x, 0, 17), 1, 52))


@pytest.mark.parametrize("bad,axis,n,error", [
    (lambda x: x.double(), 0, 5, TypeError), (lambda x: x[0, 0], 0, 5, ValueError),
    (lambda x: x, 2, 5, ValueError), (lambda x: x, 0, 0, ValueError),
])
def test_resample_refuses_what_the_kernel_does_not_take(bad, axis, n, error):
    with pytest.raises(error):
        cuda_resize.resample(bad(torch.rand((8, 9, 3))), axis, n)
