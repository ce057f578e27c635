"""The port's CUDA kernels against their plain twins, on a GPU.

Every test here carries the ``cuda`` marker and skips without a GPU.  The
file imports neither JAX nor ``ics_tpu``, so it runs on a machine with the
card and no JAX; tests/conftest.py imports JAX, so skip it there:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from ics_tpu_torch.ops import (cuda_bilateral, cuda_conv, cuda_conv_mma, cuda_correlate,
                               cuda_solver, cuda_tv)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from ics_tpu_torch._device import exact_f32

    exact_f32()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["valid", "same", "full"])
@pytest.mark.parametrize("mk,nk", [(3, 3), (9, 9), (7, 3), (31, 31)])
def test_k1_kernel_matches_twin_on_gpu(mode, mk, nk):
    dev = _need_gpu()
    a = torch.rand((3, 77, 101), device=dev)
    k = torch.rand((3, mk, nk), device=dev)
    before = cuda_conv.launches
    got = cuda_conv.conv_planar(a, k, mode)
    assert cuda_conv.launches == before + 1
    ref = cuda_conv.conv_planar_plain(a, k, mode)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mk", [3, 9, 17])
def test_k3_kernel_matches_twin_on_gpu(mk):
    dev = _need_gpu()
    u = torch.rand((3, 60 + mk - 1, 70 + mk - 1), device=dev)
    err = torch.randn((3, 60, 70), device=dev)
    got = cuda_correlate.psf_gradient_planar(u, err)
    ref = cuda_correlate.psf_gradient_plain(u, err)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(got, cuda_correlate.psf_gradient_planar(u, err))


@pytest.mark.cuda
@pytest.mark.parametrize("blind,corr", [(False, False), (True, False), (True, True)])
def test_k2_kernel_matches_twin_on_gpu(blind, corr):
    dev = _need_gpu()
    mk, m = 7, 64
    pad = mk // 2
    image = torch.rand((3, m, m), device=dev) * 0.6 + 0.2
    u = torch.nn.functional.pad(image[None], (pad,) * 4, mode="replicate")[0].contiguous()
    psf = torch.full((3, mk, mk), 1.0 / mk**2, device=dev)
    kw = dict(step_factor=1e-3, lambd=1000.0, blind=blind, correlation=corr)
    got = cuda_solver.inner_loop_planar(u.clone(), image, psf, **kw)
    again = cuda_solver.inner_loop_planar(u.clone(), image, psf, **kw)
    ref = cuda_solver.inner_loop_plain(u.clone(), image, psf, **kw)
    for g, a, r in zip(got, again, ref):
        assert float((g - r).abs().max()) <= 1e-5 * max(float(r.abs().max()), 1.0)
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["valid", "same", "full"])
@pytest.mark.parametrize("mk,nk", [(3, 3), (9, 9), (9, 5), (31, 31)])
def test_k4s_kernel_matches_twin_on_gpu(mode, mk, nk):
    dev = _need_gpu()
    a = torch.rand((3, 77, 141), device=dev)
    k = torch.rand((3, mk, nk), device=dev)
    before = cuda_conv_mma.split_launches
    got = cuda_conv_mma.conv_split(a, k, mode)
    assert cuda_conv_mma.split_launches == before + 1
    ref = cuda_conv_mma.conv_split_plain(a, k, mode)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(got, cuda_conv_mma.conv_split(a, k, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["valid", "same", "full"])
@pytest.mark.parametrize("mk,nk", [(3, 3), (7, 7), (9, 5), (31, 31)])
def test_k4_kernel_matches_twin_on_gpu(mode, mk, nk):
    dev = _need_gpu()
    a = (torch.rand((3, 77, 141), device=dev) + 0.1).bfloat16()
    k = (torch.rand((3, mk, nk), device=dev) + 0.1).bfloat16()
    before = cuda_conv_mma.bf16_launches
    got = cuda_conv_mma.conv_bf16(a, k, mode)
    assert cuda_conv_mma.bf16_launches == before + 1
    ref = cuda_conv_mma.conv_bf16_plain(a, k, mode).float()
    # within one bf16 ulp of each (positive) value
    ulp = torch.exp2(torch.floor(torch.log2(ref)) - 7)
    assert bool(((got.float() - ref).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order,norm", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_k5_kernel_matches_twin_on_gpu(order, norm, dtype):
    dev = _need_gpu()
    u = torch.rand((3, 61, 83), device=dev).to(dtype)
    before = cuda_tv.launches
    got = cuda_tv.tv_planar(u, 1e-2, order, norm)
    assert cuda_tv.launches == before + 1
    ref = cuda_tv.tv_planar_plain(u, 1e-2, order, norm)
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        # the same IEEE operations in the same order: bitwise
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 77, 101), (3, 33, 40), (2, 5, 3)])
@pytest.mark.parametrize("std_i,scale", [(0.1, 1.0), (5.0, 100.0)])
@pytest.mark.parametrize("radius", [1, 2, 5, 16])
def test_k6_kernel_matches_twin_on_gpu(radius, std_i, scale, shape):
    """Tiles of 32x32 do not divide 77x101 or 33x40; a 5x3 plane is smaller
    than 2r+1 for every radius above 1 (reflection with period 2n)."""
    dev = _need_gpu()
    src = torch.rand(shape, device=dev) * scale
    before = cuda_bilateral.launches
    got = cuda_bilateral.bilateral_planar(src, radius, std_i, 5.0)
    assert cuda_bilateral.launches == before + 1
    ref = cuda_bilateral.bilateral_planar_plain(src, radius, std_i, 5.0)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(got, cuda_bilateral.bilateral_planar(src, radius, std_i, 5.0))


@pytest.mark.cuda
def test_k6_radius_limit_raises_on_gpu():
    dev = _need_gpu()
    src = torch.rand((1, 40, 40), device=dev)
    cuda_bilateral.bilateral_planar(src, cuda_bilateral.MAX_RADIUS, 0.1, 5.0)
    before = cuda_bilateral.launches
    with pytest.raises(ValueError, match=str(cuda_bilateral.MAX_RADIUS)):
        cuda_bilateral.bilateral_planar(src, cuda_bilateral.MAX_RADIUS + 1, 0.1, 5.0)
    assert cuda_bilateral.launches == before
