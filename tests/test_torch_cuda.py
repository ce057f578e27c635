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


def _k1_case(dev, shape, mk, nk, mode):
    a = torch.rand(shape, device=dev)
    k = torch.rand((shape[0], mk, nk), device=dev)
    got = cuda_conv.conv_planar(a, k, mode)
    ref = cuda_conv.conv_planar_plain(a, k, mode)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(got, cuda_conv.conv_planar(a, k, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["valid", "same", "full"])
@pytest.mark.parametrize("mk,nk", [(3, 3), (5, 5), (7, 7), (9, 9), (11, 5), (31, 31)])
@pytest.mark.parametrize("shape", [(1, 70, 132), (3, 45, 101)])
def test_k1_sizes_and_staging_on_gpu(shape, mk, nk, mode):
    """The unrolled (3, 5, 7, 9) and run-time (11x5, 31x31) instances;
    W = 132 takes the 16-byte staging copies where the mode's column offset
    is a multiple of 4, W = 101 the 4-byte ones; neither plane is a
    multiple of the tile.  Bitwise reproducible."""
    _k1_case(_need_gpu(), shape, mk, nk, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mk,nk", [((1, 5, 4), 9, 9), ((3, 6, 7), 31, 31),
                                         ((3, 2, 3), 3, 5)])
def test_k1_plane_smaller_than_kernel_full_on_gpu(shape, mk, nk):
    _k1_case(_need_gpu(), shape, mk, nk, "full")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["valid", "full"])
@pytest.mark.parametrize("mk", [3, 9, 13])
def test_k1_persistent_ring_on_gpu(mode, mk):
    """A plane of a few hundred tiles: every block walks several tiles
    through the two-stage ring (8 rows per thread)."""
    _k1_case(_need_gpu(), (3, 300, 1030), mk, mk, mode)


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
@pytest.mark.parametrize("blind,corr", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("mk,m", [(3, 45), (5, 61), (7, 100), (9, 83), (11, 50)])
def test_k2_sizes_and_tiles_on_gpu(mk, m, blind, corr):
    """The unrolled (3, 5, 7, 9) and run-time (11) instances on windows that
    are not a multiple of the 32-column tile, on a blocky scene (uniform
    noise makes the DoF blend chaotic).  Bitwise reproducible."""
    dev = _need_gpu()
    gen = torch.Generator().manual_seed(mk * 1000 + m)
    cells = torch.rand((3, m // 4 + 1, m // 4 + 1), generator=gen) * 0.6 + 0.2
    image = cells.repeat_interleave(4, 1).repeat_interleave(4, 2)[:, :m, :m].contiguous().to(dev)
    pad = mk // 2
    u = torch.nn.functional.pad(image[None], (pad,) * 4, mode="replicate")[0].contiguous()
    psf = torch.rand((3, mk, mk), generator=gen).to(dev) + 0.5
    psf = (psf / psf.sum(dim=(1, 2), keepdim=True)).contiguous()
    kw = dict(step_factor=1e-3, lambd=1e4, blind=blind, correlation=corr)
    before = cuda_solver.launches
    got = cuda_solver.inner_loop_planar(u.clone(), image, psf, **kw)
    again = cuda_solver.inner_loop_planar(u.clone(), image, psf, **kw)
    assert cuda_solver.launches == before + 2
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


def _k4_case(dev, split, shape, mk, nk, mode):
    """K4s (split) or K4 against its twin, and bitwise equal on a second run."""
    gen = torch.Generator().manual_seed(shape[1] * 1000 + shape[2] + mk * 31 + nk)
    a = (torch.rand(shape, generator=gen) + 0.1).to(dev)
    k = (torch.rand((shape[0], mk, nk), generator=gen) + 0.1).to(dev)
    if split:
        kern, plain, counter = cuda_conv_mma.conv_split, cuda_conv_mma.conv_split_plain, "split"
    else:
        a, k = a.bfloat16(), k.bfloat16()
        kern, plain, counter = cuda_conv_mma.conv_bf16, cuda_conv_mma.conv_bf16_plain, "bf16"
    before = getattr(cuda_conv_mma, f"{counter}_launches")
    got = kern(a, k, mode)
    assert getattr(cuda_conv_mma, f"{counter}_launches") == before + 1
    ref = plain(a, k, mode)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if split:
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    else:  # within one bf16 ulp of each (positive) value
        ref = ref.float()
        ulp = torch.exp2(torch.floor(torch.log2(ref)) - 7)
        assert bool(((got.float() - ref).abs() <= ulp).all())
    assert torch.equal(got, kern(a, k, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["valid", "same", "full"])
@pytest.mark.parametrize("mk,nk", [(3, 3), (5, 5), (7, 7), (9, 9), (2, 1), (5, 3), (9, 7),
                                   (3, 5), (5, 8), (7, 9), (11, 13), (29, 31)])
@pytest.mark.parametrize("shape", [(3, 77, 141), (2, 130, 200)])
@pytest.mark.parametrize("split", [True, False])
def test_k4_sizes_and_tiles_on_gpu(split, shape, mk, nk, mode):
    """The unrolled (3, 5, 7, 9) and run-time instances, NK in {1, 3, 5, 7,
    8, 9, 13, 31} with MK != NK, on planes that are not a multiple of the
    64-column tile; 141 is odd, so the bf16 plane takes the plain loads."""
    _k4_case(_need_gpu(), split, shape, mk, nk, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mk,nk,mode", [
    ((1, 5, 4), 9, 9, "full"), ((3, 6, 7), 31, 31, "full"), ((3, 2, 3), 3, 5, "full"),
    ((1, 10, 20), 3, 3, "valid"), ((2, 15, 63), 9, 9, "same"),
])
@pytest.mark.parametrize("split", [True, False])
def test_k4_planes_smaller_than_a_tile_on_gpu(split, shape, mk, nk, mode):
    """Planes smaller than one tile, and smaller than the kernel in full."""
    _k4_case(_need_gpu(), split, shape, mk, nk, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["valid", "full"])
@pytest.mark.parametrize("mk", [3, 9, 13])
@pytest.mark.parametrize("split", [True, False])
def test_k4_ring_tail_on_gpu(split, mk, mode):
    """Blocks walk several tiles through the ring, and the tile count is
    not a multiple of the grid: the last turn is ragged."""
    dev = _need_gpu()
    c, h, w = 3, 1000, 2200
    ho, wo = (h - mk + 1, w - mk + 1) if mode == "valid" else (h + mk - 1, w + mk - 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = cuda_conv_mma.geometry(split, c, ho, wo, mk, mk, sms)
    assert g.n_tiles > g.grid and g.n_tiles % g.grid != 0
    _k4_case(dev, split, (c, h, w), mk, mk, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,nk,mode", [((3, 45, 101), 9, "valid"), ((3, 45, 101), 3, "full"),
                                           ((2, 64, 130), 3, "same"), ((1, 33, 257), 7, "same")])
def test_k4_odd_bf16_planes_take_plain_loads_on_gpu(shape, nk, mode):
    """bf16 planes of odd width, or an odd column offset (same mode with 3
    or 7 taps: qlo = 1 or 3), are staged with plain 2-byte loads."""
    _k4_case(_need_gpu(), False, shape, nk, nk, mode)


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
