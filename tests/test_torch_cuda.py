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
    ("pallas_mxu", "bf16x3", False, 9, "K4s"), ("pallas_mxu", "exact", True, 9, "K4"),
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
])
def test_solver_conv_method_routes_on_gpu(method, precision, want, not_want):
    """A non-blind op-loop solve (``inner_loop='xla'``: K2 would take this
    window and run its own convolutions) with each method: 'auto' keeps its
    K1 route, 'pallas_mxu' runs K4h or K4d and no K1; u within 1e-5 (exact)
    or 2e-2 (fast) of the 'auto' run."""
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
    """utils.selftest.certify_kernels: K1-K6 at the 24 MP shapes, the K2
    inner loop against the op loop, the glue against one op at a time."""
    from ics_tpu_torch.utils.selftest import certify_kernels

    _need_gpu()
    lines, rows = [], {}
    assert certify_kernels(report=lines.append, rows=rows), "\n".join(
        line for line in lines if "FAIL" in line or "ERROR" in line)
    assert lines[-1].split(": ")[-1].endswith("checks passed")
    keys = {"ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err"}
    assert set(rows) == {"K1", "K2", "K3", "K4s", "K4", "K4h", "K4d", "K5", "K6"}
    assert all(set(row) == keys for row in rows.values())
    # the library calls timed beside K1, K3, K4h and K4d are held against
    # the twins
    agree = [line for line in lines if "the library call computes the same function" in line]
    assert [line.split()[2] for line in agree] == ["K1", "K3", "K4h", "K4d"]


@pytest.mark.cuda
def test_bench_conv_backends_on_gpu():
    from ics_tpu_torch.utils.selftest import bench_conv_backends

    _need_gpu()
    before = _launches()
    got = bench_conv_backends(shapes=((257, 383),), n_iter=3, reps=1, report=lambda line: None)
    after = _launches()
    assert sorted(m for _, _, m in got) == ["K1", "K4", "K4d", "K4h", "K4s", "cudnn"]
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
