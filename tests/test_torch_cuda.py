"""The port's CUDA kernels against their plain twins, on a GPU.

Every test here carries the ``cuda`` marker and skips without a GPU.  The
file imports neither JAX nor ``ics_tpu``, so it runs on a machine with the
card and no JAX; tests/conftest.py imports JAX, so skip it there:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import contextlib
import statistics
import time

import pytest
import torch

from ics_tpu_torch.ops import (cuda_bilateral, cuda_conv, cuda_conv_mma, cuda_correlate,
                               cuda_outer, cuda_solver, cuda_tv)
from ics_tpu_torch.utils.selftest import HIGHEST_TOL


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


def _k3_case(dev, c, m, n, mk, nk):
    """One K3 launch against its twin, and bitwise equal on a second run."""
    gen = torch.Generator().manual_seed(m * 1000 + n + mk * 31 + nk)
    u = torch.rand((c, m + mk - 1, n + nk - 1), generator=gen).to(dev)
    err = torch.randn((c, m, n), generator=gen).to(dev)
    before = cuda_correlate.launches
    got = cuda_correlate.psf_gradient_planar(u, err)
    assert cuda_correlate.launches == before + 1
    ref = cuda_correlate.psf_gradient_plain(u, err)
    assert got.shape == (c, mk, nk)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(got, cuda_correlate.psf_gradient_planar(u, err))


@pytest.mark.cuda
@pytest.mark.parametrize("c,m,n,mk,nk", [
    (3, 363, 363, 7, 7), (3, 512, 512, 9, 9),  # the 24 MP path's op-loop windows
    (3, 60, 70, 3, 31), (2, 45, 61, 31, 31), (3, 50, 70, 11, 5), (1, 40, 33, 5, 11),
    (3, 9, 600, 5, 5), (1, 7, 530, 2, 9), (1, 5, 4, 40, 3),
])
def test_k3_sizes_on_gpu(c, m, n, mk, nk):
    """The unrolled (7, 9) and run-time instances (NK up to 31, MK above a
    chunk of 8 tap rows, non-square), two column strips (600, 530 columns),
    aligned (uN % 4 == 0) and unaligned rows."""
    _k3_case(_need_gpu(), c, m, n, mk, nk)


@pytest.mark.cuda
def test_k3_back_to_back_shapes_on_gpu():
    """Two calls in a row at two shapes: the grid barrier leaves no state
    behind; each call is one launch."""
    dev = _need_gpu()
    for c, m, n, mk, nk in [(3, 363, 363, 7, 7), (3, 512, 512, 9, 9), (3, 363, 363, 7, 7)]:
        _k3_case(dev, c, m, n, mk, nk)


@pytest.mark.cuda
@pytest.mark.parametrize("inner_loop,kernel", [("xla", False), ("pallas", True),
                                               ("pallas_unrolled", True), ("auto", True)])
def test_inner_loop_routes_k2_or_the_op_loop_on_gpu(inner_loop, kernel):
    """A blind solve on a window K2 takes: 'xla' runs the op loop (K3, no
    K2), the other values K2 (no K3)."""
    from ics_tpu_torch.models.rl_mm import RLConfig, richardson_lucy_MM

    dev = _need_gpu()
    mk, m = 5, 61
    pad = mk // 2
    gen = torch.Generator().manual_seed(5)
    cells = torch.rand((m // 4 + 1, m // 4 + 1, 3), generator=gen) * 0.6 + 0.2
    image = cells.repeat_interleave(4, 0).repeat_interleave(4, 1)[:m, :m].contiguous()
    u = torch.nn.functional.pad(image.permute(2, 0, 1)[None], (pad,) * 4,
                                mode="replicate")[0].permute(1, 2, 0).contiguous()
    psf = torch.full((mk, mk, 3), 1.0 / mk**2)
    k2_before, k3_before = cuda_solver.launches, cuda_correlate.launches
    res = richardson_lucy_MM(image, u, psf, pad + 1, m - pad - 1, pad + 1, m - pad - 1,
                             tau=1e9, iterations=3, lambd=1000.0, blind=True,
                             config=RLConfig(inner_loop=inner_loop), device=dev)
    assert res.iterations == 3 and bool(torch.isfinite(res.u).all())
    assert (cuda_solver.launches > k2_before) == kernel
    assert (cuda_correlate.launches > k3_before) != kernel


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
@pytest.mark.parametrize("radius", [0, 1, 2, 5, 16, 32])
def test_k6_kernel_matches_twin_on_gpu(radius, std_i, scale, shape):
    """Tiles of 32x64 do not divide 77x101 or 33x40; a 5x3 plane is smaller
    than 2r+1 for every radius above 1 (reflection with period 2n); radius
    0 is the centre alone, and 32's block needs over 48 KB of shared
    memory."""
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


def _solver_problem(m=61, mk=5):
    """A blocky window and its edge-padded start, (H, W, C) on the CPU."""
    pad = mk // 2
    gen = torch.Generator().manual_seed(m + mk)
    cells = torch.rand((m // 4 + 1, m // 4 + 1, 3), generator=gen) * 0.6 + 0.2
    image = cells.repeat_interleave(4, 0).repeat_interleave(4, 1)[:m, :m].contiguous()
    u = torch.nn.functional.pad(image.permute(2, 0, 1)[None], (pad,) * 4,
                                mode="replicate")[0].permute(1, 2, 0).contiguous()
    psf = torch.full((mk, mk, 3), 1.0 / mk**2)
    return image, u, psf, (pad + 1, m - pad - 1, pad + 1, m - pad - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["pam", "pd"])
@pytest.mark.parametrize("blind,corr", [(False, False), (True, False), (True, True)])
def test_pam_pd_on_gpu_match_the_cpu(solver, blind, corr):
    """TV-PAM (K1, K3, K5) and TV-PD (cuFFT, K3) on CUDA against the same
    solve on the CPU (the plain twins), at a fixed outer count."""
    from ics_tpu_torch.models.rl_pam import richardson_lucy_PAM
    from ics_tpu_torch.models.rl_pd import richardson_lucy_PD

    dev = _need_gpu()
    fn = richardson_lucy_PAM if solver == "pam" else richardson_lucy_PD
    image, u, psf, win = _solver_problem()
    kw = dict(tau=1e9, iterations=3, blind=blind, correlation=corr)
    counts = (cuda_conv.launches, cuda_correlate.launches, cuda_tv.launches)
    got = fn(image, u, psf, *win, device=dev, **kw)
    want = fn(image, u, psf, *win, device="cpu", **kw)
    launched = [a > b for a, b in zip((cuda_conv.launches, cuda_correlate.launches,
                                       cuda_tv.launches), counts)]
    assert launched == [solver == "pam", blind, solver == "pam"]
    assert got.iterations == want.iterations and got.u_full is None
    assert float((got.u.cpu() - want.u).abs().max()) <= 1e-4
    assert float((got.psf.cpu() - want.psf).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("m,mk", [(183, 3), (257, 5), (363, 7), (513, 9)])
@pytest.mark.parametrize("wrap", [False, True])
def test_k3_at_pam_and_pd_window_shapes_on_gpu(m, mk, wrap):
    """K3 at the blind windows of the 24 MP pyramid: PAM's edge-padded u
    and PD's wrap-padded u, against the twin."""
    dev = _need_gpu()
    gen = torch.Generator().manual_seed(m + mk)
    image = torch.rand((3, m, m), generator=gen).to(dev)
    p = mk // 2
    u = torch.nn.functional.pad(image[None], (p,) * 4,
                                mode="circular" if wrap else "replicate")[0]
    err = torch.randn((3, m, m), generator=gen).to(dev) * 0.01
    before = cuda_correlate.launches
    got = cuda_correlate.psf_gradient_planar(u, err)
    assert cuda_correlate.launches == before + 1
    ref = cuda_correlate.psf_gradient_plain(u, err)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(60, 70, 3), (45, 33)])
def test_metrics_device_path_on_gpu_matches_the_cpu(shape):
    from ics_tpu_torch.utils.metrics import psnr, ssim

    dev = _need_gpu()
    gen = torch.Generator().manual_seed(7)
    a = torch.rand(shape, generator=gen)
    b = torch.clamp(a + 0.05 * torch.randn(shape, generator=gen), 0.0, 1.0)
    before = cuda_conv.launches
    got = ssim(a, b, device=dev)
    assert cuda_conv.launches == before + 1
    assert abs(got - ssim(a, b, device="cpu")) <= 1e-6
    assert abs(psnr(a, b, device=dev) - psnr(a, b, device="cpu")) <= 1e-4


@pytest.mark.cuda
def test_metrics_keep_large_cuda_tensors_on_the_device():
    """Above 4M elements a CUDA tensor takes the device path in bands (K1),
    not the host path, and agrees with the host path of its CPU copy."""
    from ics_tpu_torch.utils.metrics import psnr, ssim

    dev = _need_gpu()
    gen = torch.Generator().manual_seed(9)
    a = torch.rand((1200, 1200, 3), generator=gen)
    b = torch.clamp(a + 0.02 * torch.randn(a.shape, generator=gen), 0.0, 1.0)
    before = cuda_conv.launches
    got = ssim(a.to(dev), b.to(dev))
    assert cuda_conv.launches == before + 2  # bands of 1159 and 35 output rows
    assert abs(got - ssim(a, b)) <= 1e-6
    assert abs(psnr(a.to(dev), b.to(dev)) - psnr(a, b)) <= 1e-4


@pytest.mark.cuda
def test_batched_vmap_fold_matches_map_on_gpu():
    """'vmap' folds three crop-scale lanes into one K1 launch per conv: at a
    fixed outer count each lane is within 1e-5 of its 'map' lane, and the
    fold launches K1 as one lane's solve does (10 per outer), 'map' three
    times that."""
    from parallel_fixtures import lanes

    from ics_tpu_torch.models.rl_mm import RLConfig
    from ics_tpu_torch.parallel import batched_deconvolve

    dev = _need_gpu()
    images, us, psfs, box = lanes(5, 3, 129, 5)
    # 'map' lanes on the op loop, as 'vmap' runs (K2 would take this window)
    kw = dict(iterations=6, tau=1e9, blind=False, device=dev,
              config=RLConfig(inner_loop="xla"))
    outs = {}
    for schedule in ("map", "vmap"):
        before = cuda_conv.launches
        outs[schedule] = batched_deconvolve(images, us, psfs, *box, schedule=schedule, **kw)
        outs[schedule + " K1"] = cuda_conv.launches - before
    assert outs["vmap K1"] == 10 * 6 and outs["map K1"] == 3 * 10 * 6
    assert torch.equal(outs["vmap"][2][:, 0], outs["map"][2][:, 0])
    assert float((outs["vmap"][0] - outs["map"][0]).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_one_rank_nccl_mesh_on_gpu():
    """One NCCL rank (the card's machine has one GPU): the backend is NCCL
    without asking, and the row-sharded solve over a one-rank mesh matches
    the one-device solve."""
    import socket

    import torch.distributed as dist

    from parallel_fixtures import lanes

    from ics_tpu_torch.models.rl_mm import richardson_lucy_MM
    from ics_tpu_torch.parallel import initialize, make_mesh, sharded_richardson_lucy

    dev = _need_gpu()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        images, us, psfs, box = lanes(6, 1, 95, 5)
        kw = dict(iterations=4, blind=True, step_factor=1e-3, lambd=1000.0)
        got = sharded_richardson_lucy(images[0], us[0], psfs[0], *box, 0.0, mesh=make_mesh(1),
                                      **kw)
        want = richardson_lucy_MM(images[0], us[0], psfs[0], *box, 0.0, device=dev,
                                  config=None, **kw)
        assert float((got.u - want.u).abs().max()) <= 5e-5
        assert float((got.psf - want.psf).abs().max()) <= 5e-6
        assert got.iterations == want.iterations
    finally:
        dist.destroy_process_group()


# K4h and K4d: the f32 instances of pallas_conv_mxu.py::_make_kernel at
# HIGHEST and DEFAULT, each held to its twin (the f32 convolution; the
# convolution of the bf16-rounded operands; both summed in float64) relative
# to its largest value, K4h at the certification's bound
_F32_VARIANTS = {
    "K4h": ("conv_highest", "highest", HIGHEST_TOL),
    "K4d": ("conv_default", "default", 1e-6),
}


def _f32_variant_case(dev, name, shape, mk, nk, mode):
    fn, counter, tol = _F32_VARIANTS[name]
    kern, plain = getattr(cuda_conv_mma, fn), getattr(cuda_conv_mma, f"{fn}_plain")
    gen = torch.Generator().manual_seed(shape[1] * 1000 + shape[2] + mk * 31 + nk)
    a = torch.rand(shape, generator=gen).to(dev)
    k = torch.rand((shape[0], mk, nk), generator=gen).to(dev)
    before = getattr(cuda_conv_mma, f"{counter}_launches")
    got = kern(a, k, mode)
    assert getattr(cuda_conv_mma, f"{counter}_launches") == before + 1
    ref = plain(a, k, mode)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
    assert torch.equal(got, kern(a, k, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["valid", "same", "full"])
@pytest.mark.parametrize("mk,nk", [(3, 3), (5, 5), (7, 7), (9, 9), (2, 1), (5, 3), (9, 7),
                                   (3, 5), (5, 8), (11, 13), (17, 17), (29, 31), (31, 31)])
@pytest.mark.parametrize("shape", [(3, 77, 141), (2, 130, 203), (1, 40, 35)])
@pytest.mark.parametrize("name", ["K4h", "K4d"])
def test_k4h_k4d_match_twins_on_gpu(name, shape, mk, nk, mode):
    """The unrolled (3, 5, 7, 9) and run-time instances up to 31x31 on
    planes of odd width, not a multiple of the 64-column tile, and smaller
    than one tile; within 7e-7 (K4h) and 1e-6 (K4d) of the largest value of
    the twin, and bitwise equal on a second run."""
    _f32_variant_case(_need_gpu(), name, shape, mk, nk, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mk,nk", [((1, 5, 4), 9, 9), ((3, 6, 7), 31, 31),
                                         ((3, 2, 3), 3, 5)])
@pytest.mark.parametrize("name", ["K4h", "K4d"])
def test_k4h_k4d_planes_smaller_than_kernel_on_gpu(name, shape, mk, nk):
    _f32_variant_case(_need_gpu(), name, shape, mk, nk, "full")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["valid", "full"])
@pytest.mark.parametrize("mk", [3, 9, 13])
@pytest.mark.parametrize("name", ["K4h", "K4d"])
def test_k4h_k4d_ring_tail_on_gpu(name, mk, mode):
    """Blocks walk several tiles through the two-slot ring, with a ragged
    last turn and channels that change between a block's tiles."""
    dev = _need_gpu()
    c, h, w = 3, 1000, 2200
    ho, wo = (h - mk + 1, w - mk + 1) if mode == "valid" else (h + mk - 1, w + mk - 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = cuda_conv_mma.geometry(cuda_conv_mma.VARIANTS[name], c, ho, wo, mk, mk, sms)
    assert g.n_tiles > g.grid and g.n_tiles % g.grid != 0
    _f32_variant_case(dev, name, (c, h, w), mk, mk, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mk,nk,mode", [((3, 1000, 2200), 9, 9, "valid"),
                                              ((3, 1000, 2200), 7, 7, "full"),
                                              ((3, 300, 401), 31, 29, "same")])
def test_k4h_same_bits_on_every_call_on_gpu(shape, mk, nk, mode):
    """K4h sums each output in one thread in a fixed order: three calls, on
    planes whose blocks walk several tiles across channels, give the same
    bits."""
    dev = _need_gpu()
    gen = torch.Generator().manual_seed(mk * 100 + nk)
    a = torch.rand(shape, generator=gen).to(dev)
    k = torch.rand((shape[0], mk, nk), generator=gen).to(dev)
    first = cuda_conv_mma.conv_highest(a, k, mode)
    for _ in range(2):
        assert torch.equal(cuda_conv_mma.conv_highest(a, k, mode), first)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mk,nk,mode", [((3, 520, 520), 9, 9, "valid"),
                                              ((3, 77, 141), 9, 9, "same"),
                                              ((3, 45, 101), 31, 29, "same")])
def test_k4s_in_k4h_place_fails_the_bound_on_gpu(shape, mk, nk, mode):
    """The certification's bound tells K4h from K4s on the card: at its
    inputs, K4h stays within HIGHEST_TOL of the float64 twin and K4s, the
    bf16x3 kernel, planted in its place, does not."""
    from ics_tpu_torch.utils.selftest import _Certify

    dev = _need_gpu()
    cert = _Certify(torch, dev, None, None, {})
    a = cert.rand(shape)
    k = cert.t(cert.rng.uniform(0.05, 1.0, (shape[0], mk, nk)))
    ref = cuda_conv_mma.conv_highest_plain(a, k, mode)

    def rel(got):
        return float((got - ref).abs().max() / ref.abs().max())

    assert rel(cuda_conv_mma.conv_highest(a, k, mode)) <= HIGHEST_TOL
    assert rel(cuda_conv_mma.conv_split(a, k, mode)) > HIGHEST_TOL


def _launches():
    return {"K1": cuda_conv.launches, "K4s": cuda_conv_mma.split_launches,
            "K4": cuda_conv_mma.bf16_launches, "K4h": cuda_conv_mma.highest_launches,
            "K4d": cuda_conv_mma.default_launches}


@pytest.mark.cuda
@pytest.mark.parametrize("method,precision,bf16,side,want", [
    ("auto", "exact", False, 9, "K1"), ("auto", "bf16x3", False, 9, "K4s"),
    ("auto", "bf16x3", False, 7, "K1"), ("auto", "fast", False, 9, "K1"),
    ("auto", "exact", True, 9, "K4"), ("auto", "exact", False, 33, None),
    ("pallas_mxu", "exact", False, 9, "K4h"), ("pallas_mxu", "fast", False, 9, "K4d"),
    ("pallas_mxu", "bf16x3", False, 9, "K4h"), ("mxu", "bf16x3", False, 9, "K4h"),
    ("pallas_mxu", "exact", True, 9, "K4"),
    ("pallas_mxu", "exact", False, 5, "K4h"), ("pallas_mxu", "exact", False, 33, None),
    ("mxu", "exact", False, 9, "K4h"), ("mxu", "fast", False, 3, "K4d"),
    ("mxu", "exact", True, 9, "K4"),
    ("pallas", "exact", False, 9, "K1"), ("pallas", "fast", False, 9, "K1"),
    ("pallas", "exact", True, 9, "K4"), ("pallas", "exact", False, 33, None),
    ("stencil", "exact", False, 5, "K1"), ("stencil", "exact", True, 5, "K4"),
    ("direct", "exact", False, 9, None), ("direct", "exact", True, 9, None),
    ("fft", "exact", False, 9, None),
])
def test_conv_method_routes_on_gpu(method, precision, bf16, side, want):
    """Each method's route on CUDA tensors, read from the launch counters:
    one launch of the kernel it names and none of the others (None: cuDNN
    or cuFFT); the result within the route's tolerance of the exact f32
    convolution (2e-2 where the operands are bf16 or bf16-rounded)."""
    from ics_tpu_torch.ops.conv import conv_planar

    dev = _need_gpu()
    gen = torch.Generator().manual_seed(side)
    a = torch.rand((3, 70, 133), generator=gen).to(dev)
    k = torch.rand((3, side, side), generator=gen).to(dev)
    ref = cuda_conv.conv_planar_plain(a, k, "same")
    if bf16:
        a, k = a.bfloat16(), k.bfloat16()
    before = _launches()
    got = conv_planar(a, k, "same", precision, method)
    after = _launches()
    assert {n: after[n] - before[n] for n in after} == {n: int(n == want) for n in after}
    rounded = bf16 or (precision == "fast" and method in ("pallas_mxu", "mxu"))
    tol = 2e-2 if rounded else 1e-4
    assert float((got.float() - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("method,precision,want,not_want", [
    ("auto", "exact", "K1", ("K4h", "K4d")),
    ("pallas_mxu", "exact", "K4h", ("K1", "K4d")),
    ("pallas_mxu", "fast", "K4d", ("K1", "K4h")),
    ("pallas_mxu", "high", "K4h", ("K1", "K4s", "K4d")),
    ("mxu", "high", "K4h", ("K1", "K4s", "K4d")),
])
def test_solver_conv_method_routes_on_gpu(method, precision, want, not_want):
    """A non-blind op-loop solve (``inner_loop='xla'``: K2 would take this
    window and run its own convolutions) with each method: 'auto' keeps its
    K1 route, 'pallas_mxu' runs K4h or K4d and no K1, and an explicit method
    at 'high' runs K4h, not K4s; u within 1e-5 (exact, high) or 2e-2 (fast)
    of the 'auto' run."""
    import numpy as np

    from ics_tpu_torch.models.rl_mm import RLConfig, richardson_lucy_MM
    from ics_tpu_torch.utils.selftest import make_scene

    dev = _need_gpu()
    img = make_scene(120, 130, 9, seed=5)[1].astype(np.float32) / 255.0
    u0 = np.pad(img, ((4, 4), (4, 4), (0, 0)), mode="edge")
    psf = np.ones((9, 9, 3), np.float32) / 81.0

    def run(cfg):
        return richardson_lucy_MM(img, u0, psf, 4, 116, 4, 126, 1e9, iterations=4,
                                  step_factor=1e-3, lambd=1e4, blind=False, config=cfg,
                                  verbose=False, device=dev)

    ref = run(RLConfig(inner_loop="xla"))
    before = _launches()
    got = run(RLConfig(inner_loop="xla", conv_method=method, conv_precision=precision))
    after = _launches()
    assert after[want] > before[want]
    assert all(after[n] == before[n] for n in not_want)
    tol = 2e-2 if precision == "fast" else 1e-5
    assert float((got.u - ref.u).abs().max()) <= tol * float(ref.u.abs().max())


@pytest.mark.cuda
def test_certify_kernels_passes_on_gpu():
    """utils.selftest.certify_kernels: K1-K6 at the 24 MP shapes, K7 and
    K7w, K8, the banded resize, the K2 inner loop against the op loop, the
    glue against one op at a time."""
    from ics_tpu_torch.utils.selftest import certify_kernels

    _need_gpu()
    lines, rows = [], {}
    assert certify_kernels(report=lines.append, rows=rows), "\n".join(
        line for line in lines if "FAIL" in line or "ERROR" in line)
    assert lines[-1].split(": ")[-1].endswith("checks passed")
    keys = {"ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err"}
    assert set(rows) == {"K1", "K2", "K3", "K4s", "K4", "K4h", "K4d", "K5", "K6", "K7", "K7w",
                         "K8", "resize"}
    assert all(set(row) == keys for row in rows.values())
    # the library calls timed beside K1, K3, K4h and K4d are held against
    # the twins
    agree = [line for line in lines if "the library call computes the same function" in line]
    assert [line.split()[2] for line in agree] == ["K1", "K3", "K4h", "K4d"]


@pytest.mark.cuda
def test_bench_conv_backends_on_gpu():
    from ics_tpu_torch.utils.selftest import CONV_BENCH_KERNELS, bench_conv_backends

    _need_gpu()
    before = _launches()
    got = bench_conv_backends(shapes=((257, 383),), n_iter=3, reps=1, report=lambda line: None,
                              kernels=CONV_BENCH_KERNELS)
    after = _launches()
    # JAX's (h, w, dtype, method) keys, then each kernel under its operand dtype
    methods = [(257, 383, d, m) for d in ("float32", "bfloat16")
               for m in ("pallas", "pallas_mxu", "mxu")]
    names = [(257, 383, "bfloat16" if n == "K4" else "float32", n) for n in CONV_BENCH_KERNELS]
    assert sorted(got) == sorted(methods + names)
    assert all(ms > 0 for ms in got.values())
    assert all(after[n] > before[n] for n in after)


@pytest.mark.cuda
def test_success_rate_on_gpu():
    import numpy as np

    from ics_tpu_torch.utils.selftest import bench_success_rate

    _need_gpu()
    _, rows = bench_success_rate(size=64, iterations=2, mask_size=31, report=lambda line: None)
    assert len(rows) == 12 and all(np.isfinite(r[1:5]).all() for r in rows)


@pytest.mark.cuda
def test_examples_on_gpu(tmp_path):
    import numpy as np

    from ics_tpu_torch.examples import chroma_denoise, deblur_cases, hsv_color_balance
    from ics_tpu_torch.utils.io import imread, imsave
    from ics_tpu_torch.utils.selftest import make_scene

    _need_gpu()
    frame = str(tmp_path / "scene.tif")
    imsave(frame, make_scene(64, 64, 5, seed=11)[1])
    deblur_cases.main(["crop", "--input", frame, "--dest", str(tmp_path / "dc"),
                       "--mask-size", "31", "--iterations", "4"])
    chroma_denoise.main([frame, str(tmp_path / "cd")])
    hsv_color_balance.main([frame, str(tmp_path / "hsv")])
    for path in (tmp_path / "dc" / "crop-blured-v1.tif", tmp_path / "cd" / "collab.tif.tif",
                 tmp_path / "hsv" / "scene-hue-shift.tif"):
        out = imread(str(path))
        assert out.dtype == np.uint16 and out.shape == (64, 64, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("blind,tau,early_stop,use_stopping", [
    (True, 0.0, 0.0, True), (False, 1e-4, 0.0, True), (False, 1e9, 1e-3, True),
    (False, 0.0, 1e-3, True), (True, 0.0, 1e-3, True), (True, 0.0, 0.0, False),
])
def test_k7_matches_twin_bitwise_on_gpu(blind, tau, early_stop, use_stopping):
    """K7 and its twin on the same CUDA tensors, step by step over a seeded
    M_r walk with plateaus, rises and a NaN: the same bits at every outer."""
    dev = _need_gpu()
    gen = torch.Generator().manual_seed(int(blind) + 2 * int(early_stop > 0))
    walk = torch.cumprod(1.0 + (torch.rand(60, generator=gen) - 0.7) * 2e-3, 0)
    walk[45] = float("nan")
    kw = dict(iterations=len(walk), blind=blind, tau=tau, early_stop=early_stop, patience=3,
              use_stopping=use_stopping)
    state, twin = (cuda_outer.initial_state(dev, len(walk)) for _ in range(2))
    for value in walk.tolist():
        m_r_new = torch.full((), value, dtype=torch.float32, device=dev)
        before = cuda_outer.launches
        cuda_outer.outer_stop(m_r_new if use_stopping else state[0][0], *state, **kw)
        assert cuda_outer.launches == before + 1
        cuda_outer.outer_stop_plain(m_r_new if use_stopping else twin[0][0], *twin, **kw)
        assert torch.equal(state[0].view(torch.int32), twin[0].view(torch.int32))
        assert torch.equal(state[1], twin[1]) and torch.equal(state[2], twin[2])
        if not bool(twin[2]):
            break


@pytest.mark.cuda
@pytest.mark.parametrize("label,m,mk,blind,tau,cfg", [
    ("blind K2 window", 61, 5, True, 0.0, dict(inner_loop="pallas")),
    ("blind op-loop window", 61, 7, True, 0.0, dict(inner_loop="xla", record_metrics=True)),
    ("non-blind frame", 150, 9, False, 1e-4, {}),
    ("non-blind plateau, mixed", 150, 9, False, 1e9,
     dict(dtype="mixed", early_stop=1e-2, early_stop_patience=2)),
    ("use_tv collab", 96, 5, True, 0.0, dict(use_tv=True, tv_norm="collab")),
])
def test_graph_loop_matches_the_eager_loop_bitwise_on_gpu(label, m, mk, blind, tau, cfg):
    """A solve whose outers after the first run as one WHILE-graph launch
    against the same body launched outer by outer in the host loop
    (``_eager_outer_loop()``): the same bits, outers and launches; one host
    read per solve against one per outer; K7 once per outer in both, K7w
    in the WHILE graph only."""
    from ics_tpu_torch.models import rl_mm

    dev = _need_gpu()
    image, u, psf, win = _solver_problem(m, mk)
    kw = dict(tau=tau, iterations=40, lambd=1000.0, blind=blind,
              config=rl_mm.RLConfig(**cfg), device=dev)
    (got, got_n, log), (want, want_n, _) = _both_loops(
        lambda: rl_mm.richardson_lucy_MM(image, u, psf, *win, **kw))
    assert got.iterations > 1 and bool(torch.isfinite(got.u).all())
    _check_while(log, got.iterations, got_n, want_n)
    for name in ("u", "u_full", "psf", "image", "stats"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if got.trajectory is not None:
        for key, values in got.trajectory.items():
            assert (values == want.trajectory[key]).all(), key


def _both_loops(run):
    """``run()`` in the device-state loop, then inside
    ``_eager_outer_loop()``: (result, launch-counter changes, the last
    loop_log entry) of each.  The eager one is a 'host' solve, one host
    read per outer."""
    from ics_tpu_torch.models import rl_mm

    runs = []
    for eager in (False, True):
        before = rl_mm._read_launches()
        rl_mm.loop_log.clear()
        with rl_mm._eager_outer_loop() if eager else contextlib.nullcontext():
            res = run()
        torch.cuda.synchronize()
        runs.append((res, [a - b for a, b in zip(rl_mm._read_launches(), before)],
                     rl_mm.loop_log[-1] if rl_mm.loop_log else None))
    host = runs[1][2]
    assert (host["route"], host["reads"], host["k7w"]) == ("host", host["outers"], None)
    return runs


def _check_while(log, outers, got_n, want_n, reads=1):
    """One WHILE solve of ``outers`` outers: its log, K7 and K7w once per
    outer (K7w's runs as it counted them on the card), every other counter
    as in the host loop, which launches K7 once per outer and no K7w."""
    from ics_tpu_torch.models import rl_mm

    keys = [key for *_, key in rl_mm._launch_counters()]
    k7, k7w = keys.index("k7"), keys.index("k7w")
    assert (log["route"], log["outers"], log["reads"], log["k7w"]) == ("while", outers, reads,
                                                                       outers)
    assert log["capture_ms"] > 0 and log["instantiate_ms"] > 0
    assert set(log["body_nodes"]) == set(cuda_outer.NODE_TYPES) and log["body_nodes"]["kernel"] > 0
    assert got_n[k7] == got_n[k7w] == want_n[k7] == outers and want_n[k7w] == 0
    rest = lambda n: [v for i, v in enumerate(n) if i not in (k7, k7w)]
    assert rest(got_n) == rest(want_n)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["pam", "pd"])
@pytest.mark.parametrize("blind,tau,iterations", [(True, 0.0, 40), (False, 1e-4, 40),
                                                  (False, 1e9, 6)])
def test_while_loop_pam_pd_match_the_eager_loop_bitwise_on_gpu(solver, blind, tau, iterations):
    """PAM and PD through the WHILE graph against the same body in the host
    loop: the same bits (u, psf, stats), outers and launches; one host
    read."""
    from ics_tpu_torch.models.rl_pam import richardson_lucy_PAM
    from ics_tpu_torch.models.rl_pd import richardson_lucy_PD

    dev = _need_gpu()
    fn = richardson_lucy_PAM if solver == "pam" else richardson_lucy_PD
    image, u, psf, win = _solver_problem(61, 5)
    (got, got_n, log), (want, want_n, _) = _both_loops(
        lambda: fn(image, u, psf, *win, tau=tau, iterations=iterations, blind=blind,
                   device=dev))
    assert got.iterations > 1 and bool(torch.isfinite(got.u).all())
    if tau == 1e9:
        assert (got.iterations, got.converged) == (iterations, False)
    _check_while(log, got.iterations, got_n, want_n)
    for name in ("u", "psf", "stats"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(70, 90, 3), (64, 48)])
def test_while_loop_tv_denoise_matches_the_eager_loop_bitwise_on_gpu(shape):
    """``tv_denoise`` through the WHILE graph with K7 as its counter: the
    eager loop's bits, no host read, K7 once per iteration."""
    from ics_tpu_torch.models.tv_denoise import tv_denoise

    dev = _need_gpu()
    image = torch.rand(shape, generator=torch.Generator().manual_seed(7))
    (got, got_n, log), (want, want_n, _) = _both_loops(
        lambda: tv_denoise(image, weight=0.1, iterations=20, device=dev))
    _check_while(log, 20, got_n, want_n, reads=0)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["mm", "pam", "pd", "tv_denoise"])
def test_while_loop_one_iteration_builds_no_graph_on_gpu(solver):
    """With ``iterations=1`` the one outer runs eagerly: no capture, no
    WHILE graph, no K7w, no read; the host loop's bits."""
    from ics_tpu_torch.models import rl_mm
    from ics_tpu_torch.models.rl_pam import richardson_lucy_PAM
    from ics_tpu_torch.models.rl_pd import richardson_lucy_PD
    from ics_tpu_torch.models.tv_denoise import tv_denoise

    dev = _need_gpu()
    image, u, psf, win = _solver_problem(61, 5)
    if solver == "tv_denoise":
        run = lambda: tv_denoise(image, iterations=1, device=dev)
    else:
        fn = {"mm": rl_mm.richardson_lucy_MM, "pam": richardson_lucy_PAM,
              "pd": richardson_lucy_PD}[solver]
        run = lambda: fn(image, u, psf, *win, tau=0.0, iterations=1, blind=True, device=dev)
    (got, got_n, log), (want, want_n, _) = _both_loops(run)
    assert log == dict(route="while", outers=1, reads=0, k7w=0, capture_ms=None,
                       instantiate_ms=None, body_nodes=None, body_launches=None)
    k7w = [key for *_, key in rl_mm._launch_counters()].index("k7w")
    assert got_n[k7w] == 0
    if solver == "tv_denoise":
        assert torch.equal(got, want)
    else:
        assert got.iterations == 1
        for name in ("u", "psf", "stats"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
def test_while_loop_reuses_the_capture_pool_on_gpu():
    """Every capture on a device shares one pool and one stream
    (``rl_mm._capture_pool``): solving the same problem again reserves no
    more memory, and the pool survives each solve's graph."""
    from ics_tpu_torch.models import rl_mm

    dev = _need_gpu()
    image, u, psf, win = _solver_problem(150, 9)
    kw = dict(tau=1e9, iterations=6, lambd=1000.0, blind=False, device=dev)
    reserved = []
    for _ in range(3):
        rl_mm.richardson_lucy_MM(image, u, psf, *win, **kw)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(dev))
        assert rl_mm.loop_log[-1]["route"] == "while"
    assert reserved[1] == reserved[2]
    pool, stream, done = rl_mm._capture_pool(dev)
    assert rl_mm._capture_pool(dev) == (pool, stream, done) and done.query()


@pytest.mark.cuda
def test_release_capture_pool_returns_its_blocks_on_gpu():
    """``rl_mm._release_capture_pool`` drops the device's capture pool and
    hands back its blocks, which ``empty_cache`` alone keeps; the next
    solve makes a new pool and gives the same bits."""
    from ics_tpu_torch.models import rl_mm

    dev = _need_gpu()
    image, u, psf, win = _solver_problem(150, 9)
    kw = dict(tau=1e9, iterations=6, lambd=1000.0, blind=False, device=dev)
    first = rl_mm.richardson_lucy_MM(image, u, psf, *win, **kw)
    torch.cuda.synchronize()
    pool = rl_mm._capture_pool(dev)
    torch.cuda.empty_cache()  # what stays is the capture pool's
    held = torch.cuda.memory_reserved(dev)
    rl_mm._release_capture_pool(dev)
    assert dev.index not in rl_mm._POOLS and torch.cuda.memory_reserved(dev) < held
    again = rl_mm.richardson_lucy_MM(image, u, psf, *win, **kw)
    assert rl_mm.loop_log[-1]["route"] == "while" and rl_mm._capture_pool(dev) != pool
    for name in ("u", "psf", "stats"):
        assert torch.equal(getattr(first, name), getattr(again, name)), name


@pytest.mark.cuda
def test_a_solve_under_the_profiler_takes_the_python_loop_on_gpu():
    """Under torch.profiler (CUDA activity) a solve launches no WHILE graph
    (fault E): the host loop, logged as 'host' with one read and one K7 per
    outer, with the WHILE loop's bits and no K7w."""
    from torch.profiler import ProfilerActivity, profile

    from ics_tpu_torch.models import rl_mm

    dev = _need_gpu()
    image, u, psf, win = _solver_problem(96, 5)
    kw = dict(tau=0.0, iterations=40, lambd=1000.0, blind=True, device=dev)
    want = rl_mm.richardson_lucy_MM(image, u, psf, *win, **kw)
    assert rl_mm.loop_log[-1]["route"] == "while"
    rl_mm.loop_log.clear()
    before, k7 = cuda_outer.while_launches, cuda_outer.launches
    with profile(activities=[ProfilerActivity.CUDA]):
        got = rl_mm.richardson_lucy_MM(image, u, psf, *win, **kw)
        torch.cuda.synchronize()
    assert [(e["route"], e["outers"], e["reads"]) for e in rl_mm.loop_log] == [
        ("host", got.iterations, got.iterations)]
    assert cuda_outer.while_launches == before and cuda_outer.launches - k7 == got.iterations
    for name in ("u", "psf", "stats"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


# ------------------------------------------------------------------ tracing
def _stamped(run, dev):
    """``run()`` inside a stamping tracer's frame: (result, spans)."""
    from ics_tpu_torch.utils.trace import Tracer

    tracer = Tracer(sync=False)
    with tracer.frame(dev):
        res = run()
    return res, tracer.collect(), tracer


@pytest.mark.cuda
def test_k7w_stamps_each_outer_on_gpu():
    """K7w stamps each of its runs: the stamps rise strictly, one per run
    as K7w counted them, and lie, on the host's clock, within the 'while'
    span's launch and read; 'outer 1' ends on the card before the first."""
    from ics_tpu_torch.models import rl_mm

    dev = _need_gpu()
    image, u, psf, win = _solver_problem(96, 5)
    kw = dict(tau=0.0, iterations=40, lambd=1000.0, blind=True, device=dev)
    res, spans, tracer = _stamped(lambda: rl_mm.richardson_lucy_MM(image, u, psf, *win, **kw),
                                  dev)
    assert [s["name"] for s in spans] == ["frame", "outer 1", "capture", "build", "while"]
    first, capture, build, loop = spans[1:]
    entry = rl_mm.loop_log[-1]
    assert all(s["info"] is entry for s in spans[1:]) and entry["route"] == "while"
    assert capture["device"] is None and build["device"] is None
    stamps, err = loop["k7w"], tracer.clock_err_ns
    assert len(stamps) == entry["k7w"] == res.iterations > 2
    assert all(b > a for a, b in zip(stamps, stamps[1:]))
    assert loop["device"] == (stamps[0], stamps[-1]) and loop["seq"][0] > first["seq"][1]
    assert stamps[-1] - stamps[0] <= loop["host"][1] - loop["host"][0]
    assert loop["host"][0] - err <= stamps[0] and stamps[-1] <= loop["host"][1] + err
    assert first["device"][0] < first["device"][1] <= stamps[0]


@pytest.mark.cuda
def test_tracing_changes_no_graph_node_and_no_bit_on_gpu(monkeypatch):
    """A solve traced and untraced: the same body nodes by type and the same
    bits; untraced, K7w gets no stamp buffer (a null pointer)."""
    from ics_tpu_torch.models import rl_mm

    dev = _need_gpu()
    image, u, psf, win = _solver_problem(96, 5)
    kw = dict(tau=0.0, iterations=40, lambd=1000.0, blind=True, device=dev)
    given, build = [], cuda_outer.while_build
    monkeypatch.setattr(cuda_outer, "while_build",
                        lambda *a: given.append(a[3] if len(a) > 3 else None) or build(*a))
    run = lambda: rl_mm.richardson_lucy_MM(image, u, psf, *win, **kw)
    plain = run()
    nodes = rl_mm.loop_log[-1]["body_nodes"]
    traced, spans, _ = _stamped(run, dev)
    assert given[0] is None and isinstance(given[1], torch.Tensor)
    assert given[1].dtype == torch.int64 and given[1].numel() == kw["iterations"] + 1
    assert rl_mm.loop_log[-1]["body_nodes"] == nodes and nodes["kernel"] > 0
    assert spans[-1]["info"]["body_nodes"] == nodes
    for name in ("u", "psf", "stats"):
        assert torch.equal(getattr(plain, name), getattr(traced, name)), name


@pytest.mark.cuda
def test_a_calibrated_stamp_lies_between_its_launch_and_its_sync_on_gpu():
    from ics_tpu_torch.utils import trace

    dev = _need_gpu()
    tracer = trace.Tracer(sync=False)
    offset, err = tracer.calibrate(dev)
    assert tracer.clock_err_ns == err and 0 < err < 1_000_000
    buf = torch.empty(8, dtype=torch.int64, device=dev)
    for i in range(8):
        t0 = time.perf_counter_ns()
        trace.stamp(buf, i)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter_ns()
        at = int(buf[i]) + offset
        assert t0 - err <= at <= t1 + err, (t0, at, t1, err)
    step, mean = trace.timer_resolution_ns(dev)
    assert 0 < step <= mean * 64


def _profiled_frame(dev):
    """A small frame under torch.profiler (CPU and CUDA; its solves take the
    host loop) with a stamping tracer: (spans, the profiler's events, the
    tracer)."""
    from torch.profiler import ProfilerActivity, profile

    from ics_tpu_torch.models.pipeline import deblur_module
    from ics_tpu_torch.utils.trace import Tracer

    gen = torch.Generator().manual_seed(11)
    frame = (torch.rand((96, 128, 3), generator=gen) * 255).to(torch.uint8).numpy()
    tracer = Tracer(sync=False)
    kw = dict(mask_size=41, iterations=4, verbose=False, device=dev)
    deblur_module(frame, "x", None, 5, **kw)  # warm: cuFFT plans, the allocator
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        deblur_module(frame, "x", None, 5, trace=tracer, **kw)
        torch.cuda.synchronize(dev)
    return tracer.collect(), list(prof.profiler.kineto_results.events()), tracer


def _event_ns(e):
    return e.start_ns(), e.start_ns() + e.duration_ns()


@pytest.mark.cuda
def test_spans_cover_every_device_operation_of_a_frame_on_gpu():
    """Every statement of deblur_module that launches device work lies in a
    span: each kernel, copy and set of a profiled frame was launched inside
    a stage's range, and ran on the card between that stage's two stamp
    kernels (the profiler's times of both).  The stamps the tracer read
    lie within 50 microseconds of the profiler's times of the same
    kernels, less one constant."""
    dev = _need_gpu()
    spans, events, _ = _profiled_frame(dev)
    stages = [s for s in spans if s["parent"] == spans[0]["id"]]
    assert spans[0]["name"] == "frame" and all(s["device"] is not None for s in stages)
    names = {s["name"] for s in stages}
    cpu = torch.autograd.DeviceType.CPU
    ranges = [_event_ns(e) for e in events if e.device_type() == cpu and e.name() in names]
    launches = {e.correlation_id(): _event_ns(e) for e in events
                if e.device_type() == cpu and e.name().startswith("cu")}
    # every range shows on the device too, under its span's name: not work
    device = [e for e in events if e.device_type() != cpu and e.name() not in names | {"frame"}]
    work = [e for e in device if "stamp_kernel" not in e.name()]
    # the stages follow one another: their stamps, in launch order, open and
    # close each stage in turn
    stamps = [_event_ns(e)[0] for e in sorted((e for e in device if "stamp_kernel" in e.name()),
                                             key=lambda e: e.correlation_id())]
    ours = [t for _, t in sorted((q, t) for s in stages for q, t in zip(s["seq"], s["device"]))]
    assert work and len(ranges) == len(stages) and len(stamps) == len(ours) == 2 * len(stages)
    shift = [a - b for a, b in zip(stamps, ours)]
    assert max(shift) - min(shift) <= 50_000, (min(shift), max(shift))
    stamped = list(zip(stamps[0::2], stamps[1::2]))
    for e in work:
        launch = launches[e.correlation_id()]
        assert any(a <= launch[0] and launch[1] <= b for a, b in ranges), e.name()
        a, b = _event_ns(e)
        assert any(c <= a and b <= d for c, d in stamped), (e.name(), a, b)


@pytest.mark.cuda
def test_span_host_times_match_the_profiler_ranges_on_gpu():
    """The tracer's clock and the profiler's differ by a constant: CLOCK_REALTIME
    less CLOCK_MONOTONIC (``profiler_offset_ns``), to within the profiler's
    own conversion of its cycle counter to that clock.  With that constant
    each stage span's host interval matches its record_function range
    within 50 microseconds."""
    from ics_tpu_torch.utils.trace import profiler_offset_ns

    dev = _need_gpu()
    spans, events, _ = _profiled_frame(dev)
    cpu = torch.autograd.DeviceType.CPU
    stages = [s for s in spans if s["parent"] == spans[0]["id"]]
    pairs = []
    for name in {s["name"] for s in stages}:
        mine = [s["host"] for s in stages if s["name"] == name]
        ranges = sorted(_event_ns(e) for e in events
                        if e.device_type() == cpu and e.name() == name)
        assert len(mine) == len(ranges), name
        pairs += [(name, m, r) for m, r in zip(mine, ranges)]
    offset = statistics.median(r[0] - m[0] for _, m, r in pairs)
    assert abs(offset - profiler_offset_ns()) <= 1_000_000
    for name, (a, b), (c, d) in pairs:
        assert abs(a + offset - c) <= 50_000 and abs(b + offset - d) <= 50_000, (name, a, c)


@pytest.mark.cuda
def test_a_stamped_frame_on_gpu():
    """deblur_module with Tracer(sync=False) on the WHILE path: every stage
    and 'outer 1' stamped, each solve's spans under its solve stage, the
    stamps in stream order rising, each span inside its parent on the card,
    and the frame's bits those of an untraced frame."""
    import numpy as np

    from ics_tpu_torch.models.pipeline import deblur_module
    from ics_tpu_torch.utils.trace import Tracer

    dev = _need_gpu()
    gen = torch.Generator().manual_seed(12)
    frame = (torch.rand((96, 128, 3), generator=gen) * 255).to(torch.uint8).numpy()
    kw = dict(mask_size=41, iterations=6, verbose=False, device=dev)
    want = deblur_module(frame, "x", None, 5, **kw)
    tracer = Tracer(sync=False)
    got = deblur_module(frame, "x", None, 5, trace=tracer, **kw)
    spans = tracer.collect()
    assert np.array_equal(got, want) and not tracer.collect()
    by_id = {s["id"]: s for s in spans}
    whiles = [s for s in spans if s["name"] == "while"]
    assert whiles and all(by_id[s["parent"]]["name"].startswith("solve (") for s in whiles)
    for s in spans:
        if s["name"] in ("frame", "capture", "build"):
            assert s["device"] is None
        else:
            assert s["device"] is not None and s["device"][0] <= s["device"][1], s["name"]
        parent = by_id.get(s["parent"])
        if parent is not None and parent["device"] is not None and s["device"] is not None:
            assert parent["device"][0] <= s["device"][0] <= s["device"][1] <= parent["device"][1]
    ends = sorted((q, t) for s in spans if s["seq"] for q, t in zip(s["seq"], s["device"]))
    assert all(a[1] <= b[1] for a, b in zip(ends, ends[1:]))


# the banded resize (csrc/resize.cu) against its dense twin on the card: the
# same float32 weights, an fmaf chain over the same non-zero terms.  cuBLAS
# sums a column pass in the kernel's order (bitwise equal at every pipeline
# shape) but a row pass in its own: two float32 sums of the same terms lie up
# to 2 ulps apart at values just above 1 (2.27e-7 of the largest value on an
# H100; each as far from the float64 sum rounded once), hence 2.5e-7
RESIZE_TOL = 2.5e-7


def _resize_pass_case(dev, shape, axis, n, method="cubic"):
    """One pass by the kernel against the twin on the same input, within
    RESIZE_TOL of the twin's largest value; one launch, none by the twin;
    bitwise equal on a second run."""
    from ics_tpu_torch.ops import cuda_resize

    gen = torch.Generator().manual_seed(shape[0] * 7919 + shape[1] * 31 + n + axis)
    x = torch.rand(shape, generator=gen).to(dev)
    before = cuda_resize.launches
    got = cuda_resize.resample(x, axis, n, method)
    assert cuda_resize.launches == before + 1
    ref = cuda_resize.resample_plain(x, axis, n, method)
    assert cuda_resize.launches == before + 1
    assert got.shape == ref.shape and got.is_contiguous()
    assert float((got - ref).abs().max()) <= RESIZE_TOL * float(ref.abs().max())
    assert torch.equal(got, cuda_resize.resample(x, axis, n, method))


def _resize_passes():
    from resize_cases import CELLS, passes

    return [(cell, *p) for cell in sorted(CELLS) for p in passes(*CELLS[cell])]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,shape,axis,n", _resize_passes())
def test_resize_kernel_at_the_pipelines_passes_on_gpu(cell, shape, axis, n):
    """Every pass of a frame of each cell: the frame and the estimate to
    each level (14 passes at 24 MP, 10 at 1.9 MP, which the non-blind levels
    run again) and the PSF's."""
    _resize_pass_case(_need_gpu(), shape, axis, n)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["linear", "bilinear", "trilinear", "triangle", "cubic",
                                    "bicubic", "tricubic", "lanczos3", "lanczos5"])
@pytest.mark.parametrize("shape,axis,n", [
    ((37, 41), 0, 61), ((37, 41), 1, 23),  # 2-D: an upscale, a downscale
    ((29, 33, 3), 0, 17), ((29, 33, 3), 1, 70), ((9, 9, 3), 0, 7), ((7, 9, 3), 1, 7),
    ((1, 5, 3), 1, 9), ((300, 7, 2), 0, 17),  # one row; a band of 100 taps
])
def test_resize_kernel_every_method_on_gpu(method, shape, axis, n):
    _resize_pass_case(_need_gpu(), shape, axis, n, method)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,out,passes", [
    ((2829, 4245, 3), (4003, 6003), 2), ((9, 9, 3), (7, 7), 2),
    ((37, 41, 3), (37, 80), 1), ((37, 41), (20, 41), 1), ((37, 41, 3), (37, 41), 0),
])
def test_resize_jax_launches_one_kernel_a_pass_on_gpu(shape, out, passes):
    """``resize_jax`` on the card: one launch per resized axis (a same-size
    axis takes none, a same-size call returns its input) and the twin's
    passes within RESIZE_TOL; a non-contiguous input is copied first."""
    from ics_tpu_torch.ops import cuda_resize
    from ics_tpu_torch.utils.resize import resize_jax

    dev = _need_gpu()
    x = torch.rand((shape[0] + 2, shape[1] + 2, *shape[2:]), device=dev)[1:-1, 1:-1]
    before = cuda_resize.launches
    got = resize_jax(x, out)
    assert cuda_resize.launches == before + passes
    want = x
    for axis in (0, 1):
        if want.shape[axis] != out[axis]:
            want = cuda_resize.resample_plain(want, axis, out[axis])
    assert got.shape == want.shape == (*out, *shape[2:])
    assert float((got - want).abs().max()) <= RESIZE_TOL * float(want.abs().max())
    if passes == 0:
        y = x.contiguous()
        assert resize_jax(y, out) is y


@pytest.mark.cuda
def test_resize_kernel_refuses_what_it_does_not_take_on_gpu():
    from ics_tpu_torch.ops import cuda_resize

    dev = _need_gpu()
    x = torch.rand((20, 30, 3), device=dev)
    before = cuda_resize.launches
    with pytest.raises(ValueError, match="contiguous"):
        cuda_resize.resample(x.transpose(0, 1), 0, 11)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_resize.resample(x[:, ::2], 1, 11)
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(TypeError):
            cuda_resize.resample(x.to(dtype), 0, 11)
    assert cuda_resize.launches == before
