"""The port's SSIM and PSNR against ``ics_tpu.utils.metrics`` on the CPU."""

import numpy as np
import pytest
import torch

from ics_tpu.utils import metrics as jm

from ics_tpu_torch.utils import metrics as tm

RNG = np.random.default_rng(61)


def _pair(shape, noise=0.05, scale=1.0):
    a = RNG.random(shape).astype(np.float32) * scale
    b = np.clip(a + RNG.normal(0.0, noise * scale, shape), 0.0, scale).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(40, 50, 3), (33, 29), (64, 64, 1)])
@pytest.mark.parametrize("data_range,win_size", [(1.0, 7), (255.0, 7), (1.0, 11)])
def test_ssim_device_path_matches_jax(shape, data_range, win_size):
    a, b = _pair(shape, scale=data_range)
    want = jm.ssim(a, b, data_range=data_range, win_size=win_size)
    got = tm.ssim(a, b, data_range=data_range, win_size=win_size, device="cpu")
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("shape", [(40, 50, 3), (33, 29)])
@pytest.mark.parametrize("data_range", [1.0, 255.0])
def test_psnr_device_path_matches_jax(shape, data_range):
    a, b = _pair(shape, scale=data_range)
    want = jm.psnr(a, b, data_range=data_range)
    got = tm.psnr(a, b, data_range=data_range, device="cpu")
    assert abs(got - want) <= 1e-6 * abs(want)


def test_host_path_above_4m_elements_matches_jax():
    """1200 x 1200 x 3 = 4.32M elements: the float64 host path in both."""
    a, b = _pair((1200, 1200, 3), noise=0.02)
    assert a.size >= tm._HOST_METRIC_ELEMS == jm._HOST_METRIC_ELEMS
    assert abs(tm.ssim(a, b) - jm.ssim(a, b)) <= 1e-12
    assert abs(tm.psnr(a, b) - jm.psnr(a, b)) <= 1e-9
    # a tensor on the host path is read back, not moved to a device
    assert tm.ssim(torch.from_numpy(a), torch.from_numpy(b)) == tm.ssim(a, b)


def test_device_path_above_4m_elements_matches_the_host_path():
    """A CUDA tensor of this size stays on the card: the device path, in
    two bands here, against the float64 host path."""
    a, b = _pair((1200, 1200, 3), noise=0.02)
    got = tm._ssim_device(a, b, 1.0, 7, torch.device("cpu"))
    assert abs(got - tm._ssim_host(a, b, 1.0, 7)) <= 1e-6


@pytest.mark.parametrize("band_elems", [1, 3 * 50 * 10, 3 * 50 * 23])
@pytest.mark.parametrize("win_size", [7, 11])
def test_device_path_in_bands_matches_one_band(monkeypatch, band_elems, win_size):
    """Bands of 1, 4 and 17 (13) output rows against the whole frame."""
    a, b = _pair((40, 50, 3))
    whole = tm.ssim(a, b, win_size=win_size, device="cpu")
    monkeypatch.setattr(tm, "_BAND_ELEMS", band_elems)
    assert abs(tm.ssim(a, b, win_size=win_size, device="cpu") - whole) <= 1e-7
    assert abs(whole - jm.ssim(a, b, win_size=win_size)) <= 1e-6


def test_host_and_device_paths_agree_on_the_interior():
    a, b = _pair((48, 52, 3))
    device = tm.ssim(a, b, device="cpu")
    assert abs(tm._ssim_host(a, b, 1.0, 7) - device) <= 1e-6


def test_tensors_and_identity():
    a, b = _pair((30, 30, 3))
    assert tm.ssim(torch.from_numpy(a), torch.from_numpy(b), device="cpu") == tm.ssim(
        a, b, device="cpu")
    assert abs(tm.ssim(a, a, device="cpu") - 1.0) <= 1e-6
    assert tm.psnr(a, b, device="cpu") > 20.0


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    a, b = _pair((20, 20, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.ssim(a, b)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.psnr(a, b)
