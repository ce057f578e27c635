"""The plain twins of the port's CUDA kernels against the Pallas kernels
(interpret mode on the CPU, as tests/test_pallas.py runs them) and the
wrapper contracts.  The kernels themselves are held against their twins on
a GPU by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.ops.pallas_conv import conv_rgb_pallas
from ics_tpu.ops.pallas_conv_mxu import conv_rgb_pallas_mxu
from ics_tpu.ops.pallas_correlate import correlate_psf_valid as j_corr_valid
from ics_tpu.ops.pallas_correlate import psf_gradient as j_psf_gradient
from ics_tpu.ops.pallas_solver import fits_vmem, inner_loop_pallas
from ics_tpu.ops.pallas_tv import tv_op_pallas
from ics_tpu.ops.tv import tv_op as j_tv_op
from ics_tpu.ops.tv import tv_op_auto as j_tv_op_auto
from ics_tpu.ops.windows import uniform_kernel

from ics_tpu_torch.ops import conv as tconv
from ics_tpu_torch.ops import cuda_conv, cuda_conv_mma, cuda_correlate, cuda_solver, cuda_tv
from ics_tpu_torch.ops import tv as ttv

RNG = np.random.default_rng(43)


def _planar(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 0)))


def _hwc(t):
    return np.moveaxis(t.numpy(), 0, -1)


@pytest.fixture
def zero_launches():
    mods = (cuda_conv, cuda_correlate, cuda_solver, cuda_tv)
    for mod in mods:
        mod.launches = 0
    cuda_conv_mma.split_launches = cuda_conv_mma.bf16_launches = 0
    yield
    # CPU tensors take the plain twins: no kernel may have been launched
    assert [mod.launches for mod in mods] == [0, 0, 0, 0]
    assert (cuda_conv_mma.split_launches, cuda_conv_mma.bf16_launches) == (0, 0)


@pytest.mark.parametrize("mode", ["valid", "same", "full"])
def test_k1_twin_matches_pallas_conv(mode, zero_launches):
    a = RNG.standard_normal((47, 39, 3)).astype(np.float32)
    k = RNG.standard_normal((7, 7, 3)).astype(np.float32)
    want = np.asarray(conv_rgb_pallas(a, jnp.asarray(k), mode, tile_h=16, interpret=True))
    got = _hwc(cuda_conv.conv_planar(_planar(a), _planar(k), mode))
    assert got.shape == want.shape
    # max error relative to the largest output (f32 sum orders differ)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_k3_twin_matches_pallas_psf_gradient(zero_launches):
    mk, m = 5, 43
    pad = mk // 2
    u = RNG.random((m + 2 * pad, m + 2 * pad, 3)).astype(np.float32)
    err = RNG.standard_normal((m, m, 3)).astype(np.float32)
    want = np.asarray(j_psf_gradient(jnp.asarray(u), jnp.asarray(err), tile_h=16, interpret=True))
    got = cuda_correlate.psf_gradient(torch.from_numpy(u), torch.from_numpy(err)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    want2 = np.asarray(j_corr_valid(jnp.asarray(u), jnp.asarray(err), tile_h=16, interpret=True))
    got2 = cuda_correlate.correlate_psf_valid(torch.from_numpy(u), torch.from_numpy(err)).numpy()
    assert np.abs(got2 - want2).max() <= 1e-5 * np.abs(want2).max()


@pytest.mark.parametrize("blind,corr", [(False, False), (True, False), (True, True)])
def test_k2_twin_matches_pallas_inner_loop(blind, corr, zero_launches):
    mk, m = 5, 31
    pad = mk // 2
    image = np.clip(RNG.random((m, m, 3)), 0.2, 0.8).astype(np.float32)
    u = np.pad(image, ((pad, pad), (pad, pad), (0, 0)), mode="edge").astype(np.float32)
    psf = np.dstack([uniform_kernel(mk)] * 3).astype(np.float32)
    kw = dict(step_factor=1e-3, lambd=1000.0, blind=blind, correlation=corr)
    ju, jpsf, jerr = inner_loop_pallas(
        jnp.asarray(u), jnp.asarray(image), jnp.asarray(psf), interpret=True, **kw
    )
    tu, tpsf, terr = cuda_solver.inner_loop_planar(_planar(u), _planar(image), _planar(psf), **kw)
    # the tolerances of tests/test_pallas.py:113-114 (five iterations of a
    # different f32 summation order)
    np.testing.assert_allclose(_hwc(tu), np.asarray(ju), atol=5e-5)
    np.testing.assert_allclose(_hwc(tpsf), np.asarray(jpsf), atol=1e-6)
    np.testing.assert_allclose(_hwc(terr), np.asarray(jerr), atol=5e-5)
    if corr:
        p = _hwc(tpsf)
        np.testing.assert_array_equal(p[..., 0], p[..., 1])


@pytest.mark.parametrize("mode", ["valid", "same", "full"])
@pytest.mark.parametrize("mk,nk", [(9, 9), (9, 5)])
def test_k4s_twin_matches_pallas_split_kernel(mode, mk, nk, zero_launches):
    a = RNG.random((40, 150, 3)).astype(np.float32)
    k = RNG.random((mk, nk, 3)).astype(np.float32)
    want = np.asarray(conv_rgb_pallas_mxu(a, jnp.asarray(k), mode, precision="bf16x3",
                                          interpret=True))
    got = _hwc(cuda_conv_mma.conv_split(_planar(a), _planar(k), mode))
    assert got.shape == want.shape
    # the same bf16 products; f32 sums in another order
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["valid", "same", "full"])
@pytest.mark.parametrize("mk,nk", [(9, 9), (9, 5)])
def test_k4_twin_matches_pallas_bf16_kernel(mode, mk, nk, zero_launches):
    a = RNG.random((40, 150, 3)).astype(np.float32)
    k = RNG.random((mk, nk, 3)).astype(np.float32)
    want = np.asarray(conv_rgb_pallas_mxu(jnp.asarray(a, jnp.bfloat16),
                                          jnp.asarray(k, jnp.bfloat16), mode, interpret=True))
    got = cuda_conv_mma.conv_bf16(_planar(a).to(torch.bfloat16),
                                  _planar(k).to(torch.bfloat16), mode)
    assert got.dtype == torch.bfloat16
    got = _hwc(got.float())
    want = want.astype(np.float32)
    # both round one f32 sum to bf16; the sum orders differ, so a value may
    # land on the neighbouring bf16: within one bf16 ulp of each value
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


_K4_SHAPES = [(3, 4004, 6004), (3, 512, 512), (3, 361, 361), (3, 1000, 1100), (1, 5, 4),
              (2, 130, 200), (1, 1, 1)]


@pytest.mark.parametrize("mk", range(1, cuda_conv_mma.MAX_TAPS_SIDE + 1))
@pytest.mark.parametrize("split", [True, False])
def test_k4_geometry_fits_the_card(split, mk):
    """Every tap size and plane: the block's shared memory stays under the
    227 KB one block may use, at least one block fits on an SM, and the
    grid never exceeds the tiles (every block owns a first tile)."""
    for nk in range(1, cuda_conv_mma.MAX_TAPS_SIDE + 1):
        for c, ho, wo in _K4_SHAPES:
            g = cuda_conv_mma.geometry(split, c, ho, wo, mk, nk, 132)
            assert g.smem == cuda_conv_mma.smem_bytes(split, g.inst, g.tile_rows, mk, nk)
            assert g.smem <= cuda_conv_mma.SMEM_OPT_IN < 227 * 1024 + 1
            assert g.smem + 1024 <= cuda_conv_mma.SMEM_PER_SM
            assert g.tile_rows in cuda_conv_mma.TILE_ROWS
            assert 1 <= g.grid <= g.n_tiles


def _k4_walk(g, c, ho, wo):
    """The kernel's persistent walk: block b takes tiles b, b + grid, ...;
    tile t is (channel, row tile, column tile) with the column fastest
    (csrc/conv_mma.cu tile_at).  Returns the output count of each pixel."""
    n_ct = -(-wo // cuda_conv_mma.TILE_W)
    n_rt = -(-ho // g.tile_rows)
    assert g.n_tiles == c * n_rt * n_ct
    seen = np.zeros((c, ho, wo), np.int32)
    for block in range(g.grid):
        for t in range(block, g.n_tiles, g.grid):
            ct, rest = t % n_ct, t // n_ct
            ch, i0, j0 = rest // n_rt, (rest % n_rt) * g.tile_rows, ct * cuda_conv_mma.TILE_W
            seen[ch, i0 : i0 + g.tile_rows, j0 : j0 + cuda_conv_mma.TILE_W] += 1
    return seen


@pytest.mark.parametrize("shape", [(3, 361, 361), (3, 512, 512), (3, 1000, 1100), (1, 5, 4),
                                   (2, 130, 200), (3, 77, 141)])
@pytest.mark.parametrize("split", [True, False])
def test_k4_persistent_walk_covers_every_tile_once(split, shape):
    """Each output pixel is written by exactly one tile of one block, with
    planes that are not a multiple of the tile and tile counts that are not
    a multiple of the grid (the ring's tail)."""
    c, ho, wo = shape
    for sms in (132, 7):
        g = cuda_conv_mma.geometry(split, c, ho, wo, 9, 9, sms)
        assert np.array_equal(_k4_walk(g, c, ho, wo), np.ones((c, ho, wo), np.int32))
    # a plane that gives blocks several tiles and a ragged last turn
    g = cuda_conv_mma.geometry(split, 3, 1000, 2200, 9, 9, 132)
    assert g.n_tiles > g.grid and g.n_tiles % g.grid != 0


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("mk,nk,inst", [(3, 3, 3), (5, 5, 5), (7, 7, 7), (9, 9, 9), (9, 5, 0),
                                        (1, 1, 0), (11, 11, 0), (31, 31, 0), (3, 5, 0),
                                        (8, 8, 0)])
def test_k4_unrolled_sizes_pick_their_instance(split, mk, nk, inst):
    g = cuda_conv_mma.geometry(split, 3, 4004, 6004, mk, nk, 132)
    assert g.inst == inst
    # the B table: every K4s instance reads it, K4 only at run-time sizes
    table = mk * ((8 + nk - 1 + 15) // 16) * 32 * (16 if split else 8)
    with_table = cuda_conv_mma.smem_bytes(split, 0, g.tile_rows, mk, nk)
    assert g.smem == (with_table if split or inst == 0 else with_table - table)


@pytest.mark.parametrize("mk", range(1, cuda_conv_mma.MAX_TAPS_SIDE + 1))
def test_k4h_occupancy_within_the_card(mk):
    """K4h's launches fit the card's SM: blocks per SM times the block's
    shared memory (and 1 KB each) within 228 KB, times its threads within
    the 512 that __launch_bounds__(256, 2) allows; the 24 MP 9x9 launch
    keeps 16 warps on each SM (two blocks of 8)."""
    code = cuda_conv_mma.VARIANTS["K4h"]
    for nk in range(1, cuda_conv_mma.MAX_TAPS_SIDE + 1):
        for c, ho, wo in _K4_SHAPES:
            g = cuda_conv_mma.geometry(code, c, ho, wo, mk, nk, 132)
            threads = 4 * g.tile_rows  # two warps across, one per 16 rows
            per_sm = min(cuda_conv_mma.SMEM_PER_SM // (g.smem + 1024),
                         cuda_conv_mma.THREADS_PER_SM // threads)
            assert per_sm >= 1
            assert per_sm * (g.smem + 1024) <= cuda_conv_mma.SMEM_PER_SM
            assert per_sm * threads <= cuda_conv_mma.THREADS_PER_SM
            assert g.grid <= per_sm * 132
    g = cuda_conv_mma.geometry(code, 3, 4004, 6004, 9, 9, 132)
    assert (g.tile_rows, g.grid) == (64, 264)  # 2 blocks x 256 threads per SM


def _slices3(x: np.ndarray):
    """K4h's split of float32 x (csrc/conv_mma.cu slice<kHighest>): hi and
    mid by clearing the low 16 bits, lo the exact rest (8 bits or fewer),
    each as float64."""
    def trunc(v):
        return (v.astype(np.float32).view(np.int32) & -65536).view(np.float32)

    hi = trunc(x)
    rest = x.astype(np.float32) - hi
    mid = trunc(rest)
    lo = (rest - mid).astype(np.float32)
    assert np.array_equal(lo, torch.from_numpy(lo).bfloat16().float().numpy())
    assert np.array_equal(hi.astype(np.float64) + mid + lo, x.astype(np.float64))
    return hi.astype(np.float64), mid.astype(np.float64), lo.astype(np.float64)


def test_highest_tol_tells_six_products_from_three():
    """The certification's HIGHEST_TOL against the float64 twin: K4h's six
    slice products (each exact in float64; the three it drops, mid*lo,
    lo*mid and lo*lo, come to about 1e-7) sit well inside it, leaving room
    for the kernel's f32 sums, and K4s's bf16x3 twin lies outside it, so
    K4s planted for K4h fails the check."""
    from ics_tpu_torch.utils.selftest import HIGHEST_TOL

    a = (RNG.random((3, 61, 83)) * 0.75 + 0.15).astype(np.float32)
    k = RNG.uniform(0.05, 1.0, (3, 9, 9)).astype(np.float32)
    ref = cuda_conv_mma.conv_highest_plain(torch.from_numpy(a), torch.from_numpy(k), "same")
    ah, am, al = _slices3(a)
    kh, km, kl = _slices3(k)
    f64 = torch.float64

    def conv(x, y):
        return cuda_conv_mma._conv_f64(torch.from_numpy(x), torch.from_numpy(y), "same").to(f64)

    # the products in K4h's order, each a float64 convolution of exact slices
    six = (conv(al, kh) + conv(am, km) + conv(am, kh) + conv(ah, kl) + conv(ah, km)
           + conv(ah, kh))
    exact = conv(a.astype(np.float64), k.astype(np.float64))
    rel6 = float((six - exact).abs().max() / exact.abs().max())
    split = cuda_conv_mma.conv_split_plain(torch.from_numpy(a), torch.from_numpy(k), "same")
    rel3 = float((split - ref).abs().max() / ref.abs().max())
    assert rel6 <= HIGHEST_TOL / 4
    assert rel3 > HIGHEST_TOL


def test_split_hi_lo_matches_jax():
    from ics_tpu.ops.pallas_conv_mxu import _split_hi_lo

    x = RNG.standard_normal(4096).astype(np.float32)
    jh, jl = (np.asarray(v, np.float32) for v in _split_hi_lo(jnp.asarray(x)))
    th, tl = cuda_conv_mma.split_hi_lo(torch.from_numpy(x))
    np.testing.assert_array_equal(th.float().numpy(), jh)
    np.testing.assert_array_equal(tl.float().numpy(), jl)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("norm", [1, 2])
def test_k5_twin_matches_jax_tv(order, norm, zero_launches):
    u = RNG.random((37, 29, 3)).astype(np.float32)
    eps = 1e-2
    got_tv, got_div = (_hwc(t) for t in cuda_tv.tv_planar(_planar(u), eps, order, norm))
    want_tv, want_div = (np.asarray(t) for t in j_tv_op(jnp.asarray(u), eps, order, norm))
    pal_tv, pal_div = (np.asarray(t) for t in tv_op_pallas(
        jnp.asarray(u), eps, order, norm, tile_h=16, interpret=True))
    # the same ops in the same order as tv_op: the divergence and the L1
    # magnitude are bitwise equal; XLA evaluates the L2 magnitude's
    # x*x + y*y + eps^2 in its own way (one ulp)
    np.testing.assert_array_equal(got_div, want_div)
    if norm == 1:
        np.testing.assert_array_equal(got_tv, want_tv)
    for got, want in [(got_tv, want_tv), (got_tv, pal_tv), (got_div, pal_div)]:
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("collab", [False, "sup", "l2"])
@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_tv_op_auto_couplings_match_jax(collab, method, zero_launches):
    u = RNG.random((23, 31, 3)).astype(np.float32)
    want = j_tv_op_auto(jnp.asarray(u), 1e-6, order=2, norm=2, method=method, collab=collab)
    got = ttv.tv_op_auto(torch.from_numpy(u), 1e-6, order=2, norm=2, method=method,
                         collab=collab)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-6 * np.abs(np.asarray(w)).max()


def test_conv_dispatch_routes_by_dtype_and_precision(monkeypatch):
    calls = []
    for mod, name in [(cuda_conv, "conv_planar"), (cuda_conv_mma, "conv_split"),
                      (cuda_conv_mma, "conv_bf16")]:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name: calls.append(name) or fn(*a))
    a = torch.rand((3, 40, 40))
    k9, k5, k33 = (torch.rand((3, s, s)) for s in (9, 5, 33))
    tconv.conv_planar(a, k9, "same", precision="bf16x3")  # 81 taps: K4s
    tconv.conv_planar(a, k5, "same", precision="bf16x3")  # 25 taps: exact, K1
    tconv.conv_planar(a, k9, "same")
    tconv.conv_planar(a.bfloat16(), k5.bfloat16(), "same")  # every bf16 conv: K4
    out = tconv.conv_planar(a.bfloat16(), k33.bfloat16(), "valid")  # FFT in f32
    assert out.dtype == torch.bfloat16 and out.shape == (3, 8, 8)
    assert calls == ["conv_split", "conv_planar", "conv_planar", "conv_bf16"]
    with pytest.raises(ValueError, match="unknown precision"):
        tconv.conv_planar(a, k9, "same", precision="bf16x6")


@pytest.mark.parametrize("side", [131, 185, 261, 262, 330, 331, 369, 520])
def test_k2_window_bound_is_the_jax_bound(side):
    assert cuda_solver.fits(side, side) == fits_vmem(side, side)


def test_wrappers_reject_bad_input():
    a = torch.zeros((3, 10, 10))
    with pytest.raises(TypeError, match="float32"):
        cuda_conv.conv_planar(a.double(), torch.zeros((3, 3, 3), dtype=torch.float64), "same")
    with pytest.raises(ValueError, match="unknown mode"):
        cuda_conv.conv_planar(a, torch.zeros((3, 3, 3)), "circular")
    with pytest.raises(ValueError, match="at least as large"):
        cuda_conv.conv_planar(a, torch.zeros((3, 11, 3)), "valid")
    with pytest.raises(ValueError, match="expected"):
        cuda_conv.conv_planar(a, torch.zeros((2, 3, 3)), "same")
    with pytest.raises(ValueError, match="at least as large"):
        cuda_correlate.psf_gradient_planar(torch.zeros((3, 5, 5)), torch.zeros((3, 6, 6)))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_conv.conv_planar(a.to("meta"), torch.zeros((3, 3, 3), device="meta"), "same")
    with pytest.raises(TypeError, match="float32"):
        cuda_conv_mma.conv_split(a.bfloat16(), torch.zeros((3, 3, 3), dtype=torch.bfloat16), "same")
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_conv_mma.conv_bf16(a, torch.zeros((3, 3, 3)), "same")
    with pytest.raises(ValueError, match="taps up to"):
        cuda_conv_mma.conv_split(torch.zeros((3, 40, 40)), torch.zeros((3, 33, 3)), "same")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_conv_mma.conv_split(a.to("meta"), torch.zeros((3, 3, 3), device="meta"), "same")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_tv.tv_planar(a.double(), 1e-2)
    with pytest.raises(ValueError, match="order"):
        cuda_tv.tv_planar(a, 1e-2, order=3)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_tv.tv_planar(a.to("meta"), 1e-2)
    with pytest.raises(ValueError, match="unknown collab"):
        ttv.tv_op_auto(torch.zeros((5, 5, 3)), 1e-2, collab="l1")


_K3_SHAPES = [(3, 512, 512), (3, 363, 363), (3, 60, 70), (1, 5, 4), (2, 9, 1100),
              (3, 4000, 6000)]


def _k3_walk(g, c, m, n, mk, nk):
    """Each (channel, tap row, error row, error column) as often as the
    kernel's units cover it, and each (channel, tap, slot) partial as often
    as a unit writes it (csrc/psf_grad.cu's unit decomposition)."""
    cover = np.zeros((c, mk, m, n), np.int32)
    writes = np.zeros((c, mk, nk, g.n_bands * g.n_strips), np.int32)
    n_chunks = -(-mk // g.tr)
    assert g.n_units == c * n_chunks * g.n_bands * g.n_strips
    for unit in range(g.n_units):
        strip, rest = unit % g.n_strips, unit // g.n_strips
        band, rest = rest % g.n_bands, rest // g.n_bands
        chunk, ch = rest % n_chunks, rest // n_chunks
        r0, t0, j0 = band * g.band_rows, chunk * g.tr, strip * g.ws
        rows, trn = min(g.band_rows, m - r0), min(g.tr, mk - t0)
        assert rows >= 1 and trn >= 1
        # the stage holds rows + trn - 1 rows of the budget's
        assert 4 * g.stage_w * (rows + trn - 1) <= g.smem
        cols = min(g.ws, n - j0)
        cover[ch, t0 : t0 + trn, r0 : r0 + rows, j0 : j0 + cols] += 1
        writes[ch, t0 : t0 + trn, :, band * g.n_strips + strip] += 1
    return cover, writes


@pytest.mark.parametrize("mk", range(3, 32))
def test_k3_geometry_covers_every_product_once(mk):
    """For mk 3-31 (square, and against 1, 5 and 32 columns), on the
    solver's windows and beyond: the units cover every (channel, tap row,
    error pixel) once and write every partial once; the stage fits its
    budget and reaches every column a thread's window loads; the grid fits
    the card and has work for every block; the tap rows go one unit per
    chunk of 8 (a warp each) where the sums do not fit in registers."""
    for nk in sorted({mk, 1, 5, 32}):
        inst, tb = cuda_correlate.instance(mk, nk)
        assert (inst, tb) == ((mk, mk) if mk == nk and mk in (3, 5, 7, 9)
                              else (0, 8 if nk <= 8 else 16 if nk <= 16 else 32))
        for c, m, n in _K3_SHAPES:
            for sms, per_sm in [(132, 1), (132, 2), (132, 3), (7, 1)]:
                g = cuda_correlate.geometry(c, m, n, mk, nk, sms, per_sm)
                assert g.tr == (mk if inst else cuda_correlate.CHUNK_ROWS)
                assert g.smem == 4 * g.stage_w * (g.band_rows + g.tr - 1)
                assert g.smem <= cuda_correlate.SMEM_BUDGET
                assert 1 <= g.grid <= min(g.n_units, sms * per_sm)
                assert g.ws % 4 == 0 and g.n_strips * g.ws >= n > (g.n_strips - 1) * g.ws
                assert g.n_bands * g.band_rows >= m > (g.n_bands - 1) * g.band_rows
                # the last item's window: 4 columns plus tb - 1 more, in
                # 16-byte loads
                assert g.ws - 4 + 4 * -(-(3 + tb) // 4) <= g.stage_w
                if c * m * n <= 3 * 60 * 70 or (m == 512 and mk <= 9 and per_sm == 2):
                    cover, writes = _k3_walk(g, c, m, n, mk, nk)
                    assert (cover == 1).all() and (writes == 1).all()


def test_k3_geometry_gives_the_card_a_unit_per_block_on_the_solver_windows():
    # the 24 MP path's op-loop windows, at one and two blocks per SM
    for m, mk in [(363, 7), (512, 9)]:
        for per_sm in (1, 2):
            g = cuda_correlate.geometry(3, m, m, mk, mk, 132, per_sm)
            assert g.grid == g.n_units and 0.8 * 132 * per_sm <= g.grid <= 132 * per_sm
            assert g.n_strips == 1 and g.inst == mk


def test_k3_geometry_rejects_wide_taps():
    with pytest.raises(ValueError, match="NK"):
        cuda_correlate.geometry(3, 40, 40, 3, 33, 132, 1)


@pytest.mark.parametrize("std_i,scale", [(0.1, 1.0), (5.0, 100.0)])
@pytest.mark.parametrize("radius", [0, 2, 5])
def test_k6_folded_constants_reproduce_the_twin(radius, std_i, scale):
    """csrc/bilateral.cu's arithmetic in float32 torch: one base-2
    exponential per weight of the host-folded (s, a), the norms dropped
    (they cancel in num / den), rows of offsets in the twin's order."""
    from ics_tpu_torch.ops import cuda_bilateral as cb
    from ics_tpu_torch.ops.conv import pad_symmetric

    src = torch.from_numpy((RNG.random((2, 23, 31)) * scale).astype(np.float32))
    s, a = cb._kernel_constants(std_i, 5.0)
    padded = pad_symmetric(src, (radius, radius), (radius, radius))
    _, h, w = src.shape
    cs = src * s
    num = torch.zeros_like(src)
    den = torch.zeros_like(src)
    for dy in range(2 * radius + 1):
        er = -(np.float32(a) * np.float32(dy - radius) ** 2)
        for dx in range(2 * radius + 1):
            ex = -(np.float32(a) * np.float32(dx - radius) ** 2)
            nb = padded[:, dy : dy + h, dx : dx + w]
            t = nb * s - cs
            wgt = torch.exp2(-t * t + np.float32(er + ex))
            num = num + nb * wgt
            den = den + wgt
    ref = cb.bilateral_planar_plain(src, radius, std_i, 5.0)
    assert float((num / den - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("mk", range(1, cuda_conv_mma.MAX_TAPS_SIDE + 1))
@pytest.mark.parametrize("variant", ["K4h", "K4d"])
def test_k4h_k4d_geometry_fits_the_card(variant, mk):
    """K4h (three slice tiles, 24-byte B entries) and K4d (one slice tile,
    8-byte entries) fit one block in shared memory at every tap size up to
    31x31, and their persistent walk covers every output once."""
    code = cuda_conv_mma.VARIANTS[variant]
    for nk in range(1, cuda_conv_mma.MAX_TAPS_SIDE + 1):
        for c, ho, wo in _K4_SHAPES:
            g = cuda_conv_mma.geometry(code, c, ho, wo, mk, nk, 132)
            assert g.smem == cuda_conv_mma.smem_bytes(code, g.inst, g.tile_rows, mk, nk)
            assert g.smem <= cuda_conv_mma.SMEM_OPT_IN
            assert g.smem + 1024 <= cuda_conv_mma.SMEM_PER_SM
            assert 1 <= g.grid <= g.n_tiles
    g = cuda_conv_mma.geometry(code, 3, 1000, 2200, mk, mk, 132)
    assert np.array_equal(_k4_walk(g, 3, 1000, 2200), np.ones((3, 1000, 2200), np.int32))


@pytest.mark.parametrize("variant,slices,entry", [("K4s", 2, 16), ("K4h", 3, 24), ("K4d", 1, 8)])
def test_f32_variants_shared_memory(variant, slices, entry):
    """The f32 variants' block: two f32 ring slots and two slots of their
    bf16 slice tiles (4 + 2 * slices bytes per staged value, twice), and one
    B table of 32 lanes' entries per tap row and k-step, a bf16 pair per
    slice (rebuilt when a block's tile changes channel); K4s's matches the
    split flag's formula."""
    code = cuda_conv_mma.VARIANTS[variant]
    for mk, nk, tile_rows in [(9, 9, 64), (31, 31, 16), (5, 17, 32)]:
        plane = (tile_rows + mk - 1) * (56 + 16 * ((8 + nk - 1 + 15) // 16))
        table = mk * ((8 + nk - 1 + 15) // 16) * 32 * entry
        want = 2 * (4 + 2 * slices) * plane + table
        assert cuda_conv_mma.smem_bytes(code, 0, tile_rows, mk, nk) == want
    assert cuda_conv_mma.smem_bytes(True, 0, 64, 9, 9) == \
        cuda_conv_mma.smem_bytes(cuda_conv_mma.VARIANTS["K4s"], 0, 64, 9, 9)
