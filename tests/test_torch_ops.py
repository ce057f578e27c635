"""ics_tpu_torch ops against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages as numpy arrays.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.ops import conv as jconv
from ics_tpu.ops import psf as jpsf
from ics_tpu.ops import reductions as jred
from ics_tpu.ops import windows as jwin
from ics_tpu.utils.resize import resize_jax as jresize

from ics_tpu_torch.ops import conv as tconv
from ics_tpu_torch.ops import psf as tpsf
from ics_tpu_torch.ops import reductions as tred
from ics_tpu_torch.ops import windows as twin
from ics_tpu_torch.utils.resize import resize_jax as tresize

RNG = np.random.default_rng(41)


def _close(got, want, rel):
    """max |got - want| <= rel * max |want| (sum orders differ)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("mode", ["valid", "same", "full"])
@pytest.mark.parametrize("mk,nk", [(3, 3), (5, 5), (9, 9), (7, 3), (35, 33)])
def test_convolve_rgb_matches_jax(mode, mk, nk):
    # (35, 33) is above K1's 31x31 bound: the FFT path
    a = RNG.standard_normal((47, 52, 3)).astype(np.float32)
    k = RNG.standard_normal((mk, nk, 3)).astype(np.float32)
    want = jconv.convolve_rgb(jnp.asarray(a), jnp.asarray(k), mode)
    got = tconv.convolve_rgb(torch.from_numpy(a), torch.from_numpy(k), mode)
    _close(got, want, rel=1e-5)


def test_convolve2d_and_broadcast_kernel_match_jax():
    a = RNG.standard_normal((40, 33)).astype(np.float32)
    k = RNG.standard_normal((5, 7)).astype(np.float32)
    want = jconv.convolve2d(jnp.asarray(a), jnp.asarray(k), "same")
    _close(tconv.convolve2d(torch.from_numpy(a), torch.from_numpy(k), "same"), want, 1e-5)
    a3 = RNG.standard_normal((30, 31, 3)).astype(np.float32)
    want3 = jconv.convolve_rgb(jnp.asarray(a3), jnp.asarray(k), "full")
    _close(tconv.convolve_rgb(torch.from_numpy(a3), torch.from_numpy(k), "full"), want3, 1e-5)


@pytest.mark.parametrize("n", [1, 2, 7, 97, 1000, 4099, 12289])
def test_next_fast_len_matches_jax(n):
    assert tconv._next_fast_len(n) == jconv._next_fast_len(n)


def test_fft_autocorrelate_same_matches_jax():
    p = RNG.standard_normal((33, 41, 3)).astype(np.float32)
    want = jconv.fft_autocorrelate_same(jnp.asarray(p))
    _close(tconv.fft_autocorrelate_same(torch.from_numpy(p)), want, rel=1e-6)


@pytest.mark.parametrize("hw", [(1, 1), (31, 31), (17, 40)])
def test_whiteness_weights_exact(hw):
    np.testing.assert_array_equal(tred.whiteness_weights(*hw), jred.whiteness_weights(*hw))


def test_windows_exact():
    np.testing.assert_array_equal(twin.uniform_kernel(7), jwin.uniform_kernel(7))
    np.testing.assert_array_equal(twin.gaussian_kernel(7, 1.5), jwin.gaussian_kernel(7, 1.5))


@pytest.mark.parametrize("shape", [(5, 5), (7, 7, 3)])
def test_normalize_kernel_and_rotate_match_jax(shape):
    k = RNG.standard_normal(shape).astype(np.float32)
    _close(tpsf.normalize_kernel(torch.from_numpy(k)),
           jpsf.normalize_kernel(jnp.asarray(k)), rel=1e-6)
    np.testing.assert_array_equal(
        tpsf.rotate_180(torch.from_numpy(k)).numpy(), np.asarray(jpsf.rotate_180(jnp.asarray(k)))
    )


@pytest.mark.parametrize(
    "src,dst",
    [
        ((61, 83, 3), (43, 59)),   # pyramid downscale (antialiased)
        ((43, 59, 3), (61, 83)),   # upscale between levels
        ((101, 77, 3), (101, 55)),  # one axis unchanged
        ((9, 9, 3), (7, 7)),       # the 9 -> 7 PSF of the 24 MP pyramid
        ((5, 5, 3), (5, 5)),       # identity
    ],
)
def test_resize_matches_jax_image_resize(src, dst):
    x = RNG.random(src).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(x), dst))
    got = tresize(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_entry_calls_turn_tf32_off():
    from ics_tpu_torch import richardson_lucy_MM

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    tresize(torch.ones((8, 8, 3)), (5, 5))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    img = np.full((9, 9, 3), 0.5, np.float32)
    u = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    psf = np.full((3, 3, 3), 1 / 9, np.float32)
    richardson_lucy_MM(img, u, psf, 2, 7, 2, 7, 0.0, iterations=1, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cuda_request_without_gpu_raises(monkeypatch):
    from ics_tpu_torch._device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, ics_tpu_torch, ics_tpu_torch.deconvolution; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'ics_tpu' or m.startswith('ics_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
