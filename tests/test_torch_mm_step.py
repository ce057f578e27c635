"""K8, the MM step (``ops/cuda_step.py``, ``csrc/mm_step.cu``): steps 4-8 of
the op loop's inner iteration in parity mode.

On the CPU: the routing rule as a pure function, K8's launch geometry, and
the op loop's default step (and ``inner_loop_plain``, K2's twin) bitwise
the parity-mode op loop as it was written before K8 existed.  On a GPU
(``cuda`` marker, skipped without one): K8 against the PyTorch ops it
replaces, bitwise, NaN at the same places; and a whole solve through the
WHILE graph with K8 against the host loop with the ops.  The file
imports neither JAX nor ``ics_tpu``, so on a machine with the card and no
JAX:

    python -m pytest tests/test_torch_mm_step.py --noconftest -q
"""

from __future__ import annotations

import pytest
import torch

from ics_tpu_torch.models import rl_mm
from ics_tpu_torch.ops import cuda_step
from ics_tpu_torch.ops.cuda_conv import conv_planar, conv_planar_plain
from ics_tpu_torch.ops.cuda_correlate import psf_gradient_plain, psf_gradient_planar
from ics_tpu_torch.ops.cuda_solver import inner_loop_ops, inner_loop_plain
from ics_tpu_torch.ops.psf import project_planar
from ics_tpu_torch.utils import selftest

F32, BF16 = torch.float32, torch.bfloat16


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from ics_tpu_torch._device import exact_f32

    exact_f32()
    return torch.device("cuda")


def _problem(m, n, mk, seed, device="cpu"):
    """A blocky (3, m, n) image in [0.2, 0.8], its edge-padded u and a
    normalized (3, mk, mk) PSF."""
    gen = torch.Generator().manual_seed(seed)
    cells = torch.rand((3, m // 4 + 1, n // 4 + 1), generator=gen) * 0.6 + 0.2
    image = cells.repeat_interleave(4, 1).repeat_interleave(4, 2)[:, :m, :n].contiguous()
    image = image + torch.rand(image.shape, generator=gen) * 0.01
    pad = mk // 2
    u = torch.nn.functional.pad(image[None], (pad,) * 4, mode="replicate")[0].contiguous()
    psf = torch.rand((3, mk, mk), generator=gen) + 0.5
    psf = psf / psf.sum(dim=(1, 2), keepdim=True)
    return tuple(t.to(device) for t in (image, u, psf))


def _inner_loop_before(u, image, psf, *, step_factor, lambd, blind, correlation):
    """The parity-mode op loop as ``inner_loop_ops`` ran it before it took a
    step backend (one device, no guard, no TV, not mixed), on the plain
    convolution and PSF-gradient twins."""
    _, u_m, u_n = u.shape
    _, m, n = image.shape
    mk = psf.shape[1]
    pad = (u_m - m) // 2
    crop = (slice(None), slice(pad, pad + m), slice(pad, pad + n))
    sf = torch.full((), step_factor, dtype=torch.float32, device=u.device)
    inv_un = 1.0 / (u_m * u_n)
    ut = u
    psf_rot = torch.flip(psf, dims=(1, 2)).contiguous()
    error = None
    for _ in range(5):
        error = conv_planar_plain(u, psf, "valid") - image
        gradu = conv_planar_plain(error, psf_rot, "full")
        gcrop = gradu[crop]
        dof = ((gcrop - image) / (gcrop + image)) ** 2
        if not blind:
            dof = dof / lambd
        greg = lambd * gradu + (u - ut) / 2.0
        u_max, greg_max = [torch.amax(x, dim=(1, 2)) for x in (u, torch.abs(greg))]
        dt = sf * (u_max + inv_un) / (greg_max + 1e-15)
        u = u - dt[:, None, None] * greg
        u[crop] = (1.0 - dof) * u[crop] + dof * image
        if blind:
            error = conv_planar_plain(u, psf, "valid") - image
            gradk = psf_gradient_plain(u, error)
            dtpsf = sf / mk * (torch.amax(psf) + 1.0 / (u_m * u_n * 3)) / (
                torch.amax(torch.abs(gradk)) + 1e-15
            )
            psf = project_planar(psf - dtpsf * gradk, correlation, 1)
            psf_rot = torch.flip(psf, dims=(1, 2)).contiguous()
    return u, psf, error


def _same_bits(got, want) -> bool:
    """Bitwise equal float32 tensors, NaN at the same places (a NaN's
    payload aside)."""
    return got.dtype == want.dtype == torch.float32 and selftest._same_bits(torch, got, want)


# ------------------------------------------------------------------ CPU

_PARITY = dict(device_type="cuda", compute=F32, use_tv=False, guard=False, mixed=False, lanes=1,
               shard=None)


@pytest.mark.parametrize("change, want", [
    ({}, True),
    ({"device_type": "cpu"}, False),
    ({"compute": BF16}, False),
    ({"use_tv": True}, False),
    ({"guard": True}, False),
    ({"mixed": True}, False),
    ({"lanes": 2}, False),
    ({"shard": object()}, False),
])
def test_mm_step_route(change, want):
    """K8 takes the parity-mode float32 solve of one image on one CUDA
    device, and nothing else."""
    assert rl_mm.mm_step_route(**{**_PARITY, **change}) is want


@pytest.mark.parametrize("channels, plane, sms", [(3, 4009 * 6009, 132), (3, 369 * 369, 132),
                                                  (3, 1, 132), (3, 3, 132), (9, 1381 * 1409, 132),
                                                  (1, 1024, 1), (3, 5001, 2), (3, 4096, 132)])
def test_mm_step_geometry(channels, plane, sms):
    """Every element in one block's chunk, each chunk a multiple of 4, no
    block empty but possibly the last (its chunk starts up to 3 elements
    later in a channel with a head), at most one wave of resident blocks over
    the channels (or one block a channel)."""
    blocks, chunk = cuda_step.geometry(channels, plane, sms)
    assert blocks >= 1 and chunk >= 4 and chunk % 4 == 0
    assert blocks * chunk >= plane and (blocks - 1) * chunk < plane
    assert channels * blocks <= max(channels, sms * cuda_step.BLOCKS_PER_SM + channels)


@pytest.mark.parametrize("blind, correlation", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("m, n, mk", [(24, 31, 5), (33, 20, 7)])
def test_the_default_step_is_the_ops_as_before(blind, correlation, m, n, mk):
    """``inner_loop_ops`` with no step backend, ``inner_loop_plain`` and the
    op loop with the step twin (``mm_step`` on CPU tensors) give the bits of
    the op loop as it was written before K8."""
    image, u, psf = _problem(m, n, mk, seed=m + n + mk)
    kw = dict(step_factor=1e-3, lambd=1000.0 / 3.0, blind=blind, correlation=correlation)
    want = _inner_loop_before(u.clone(), image, psf, **kw)
    ops = dict(conv=conv_planar_plain, psf_grad=psf_gradient_plain)
    for got in (inner_loop_ops(u.clone(), image, psf, **ops, **kw)[:3],
                inner_loop_plain(u.clone(), image, psf, **kw),
                inner_loop_ops(u.clone(), image, psf, step=cuda_step.mm_step, **ops, **kw)[:3]):
        assert all(_same_bits(g, w) for g, w in zip(got, want))


def test_a_step_backend_takes_parity_mode_only():
    image, u, psf = _problem(16, 16, 3, seed=1)
    kw = dict(step_factor=1e-3, lambd=1000.0, blind=False, correlation=False,
              conv=conv_planar_plain, psf_grad=psf_gradient_plain, step=cuda_step.mm_step)
    with pytest.raises(ValueError, match="parity mode"):
        inner_loop_ops(u, image, psf, guard=True, **kw)
    with pytest.raises(ValueError, match="parity mode"):
        inner_loop_ops(u, image, psf, tv=lambda a, norm: (a, a), **kw)


@pytest.mark.parametrize("blind", [False, True])
def test_a_solve_routed_to_the_step_keeps_its_bits_on_the_cpu(monkeypatch, blind):
    """The solver's plumbing: routed to ``mm_step`` (its twin on the CPU), a
    solve returns the bits of the unrouted one."""
    image, u, psf = _problem(40, 44, 5, seed=7)
    hwc = lambda t: t.permute(1, 2, 0).contiguous()
    args = (hwc(image), hwc(u), hwc(psf), 3, 37, 3, 41)
    kw = dict(tau=1e9, iterations=3, lambd=1000.0 / 3.0, blind=blind,
              config=rl_mm.RLConfig(inner_loop="xla"), device="cpu")
    want = rl_mm.richardson_lucy_MM(*args, **kw)
    steps = []
    real = rl_mm.inner_loop_ops
    monkeypatch.setattr(rl_mm, "mm_step_route", lambda **_: True)
    monkeypatch.setattr(rl_mm, "inner_loop_ops",
                        lambda *a, **k: steps.append(k["step"]) or real(*a, **k))
    got = rl_mm.richardson_lucy_MM(*args, **kw)
    assert steps and all(s is cuda_step.mm_step for s in steps)
    assert _same_bits(got.u, want.u) and _same_bits(got.psf, want.psf)
    assert got.iterations == want.iterations


# ------------------------------------------------------------------ card


def _step_case(dev, c, u_m, u_n, m, n, blind, lambd, seed, plant=None, offset=0):
    """K8 and its twin on the same CUDA inputs: bitwise, NaN at the same
    places, two launches a call, two calls the same bits.  ``offset``: u
    starts that many floats into its storage (not on 16 bytes)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    u = rand(c, u_m, u_n) * 0.7 + 0.15
    if offset:
        buf = torch.empty(u.numel() + offset, device=dev)
        buf[offset:] = u.reshape(-1)
        u = buf[offset:].view(c, u_m, u_n)
        assert u.is_contiguous() and u.data_ptr() % 16 != 0
    ut = u if seed % 2 else u + (rand(c, u_m, u_n) - 0.5) * 1e-3
    gradu = (rand(c, u_m, u_n) - 0.5) * 2e-4 + u * 0.9
    image = rand(c, m, n) * 0.7 + 0.15
    if plant is not None:
        plant(u, gradu, image)
    kw = dict(step_factor=1e-3, lambd=lambd, blind=blind)
    before = cuda_step.launches
    got = cuda_step.mm_step(u, ut, gradu, image, **kw)
    again = cuda_step.mm_step(u, ut, gradu, image, **kw)
    torch.cuda.synchronize()
    assert cuda_step.launches == before + 4
    want = cuda_step.mm_step_plain(u, ut, gradu, image, **kw)
    assert _same_bits(got, want), float((got - want).abs().nan_to_num(0.0).max())
    assert _same_bits(again, got)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("blind", [False, True])
@pytest.mark.parametrize("lambd", [1000.0 / 3.0, 1e4, 0.0])
@pytest.mark.parametrize("shape", [(3, 45, 61, 37, 53), (3, 64, 96, 56, 88), (3, 37, 50, 37, 50),
                                   (3, 40, 41, 38, 39), (1, 7, 5, 3, 1), (6, 300, 1031, 292, 1023)])
def test_k8_matches_the_ops_on_gpu(shape, lambd, blind):
    """Odd and even windows, the crop's pad from 4 down to 0, one channel
    and six, lambd not a power of two, and 0 (a division by zero)."""
    _step_case(_need_gpu(), *shape, blind, lambd, seed=sum(shape) + blind)


@pytest.mark.cuda
@pytest.mark.parametrize("blind", [False, True])
def test_k8_on_a_window_off_16_bytes_on_gpu(blind):
    """A window whose planes hold a multiple of 4 floats but whose storage
    starts 4 bytes past 16: the 4-byte loads."""
    _step_case(_need_gpu(), 3, 64, 96, 56, 88, blind, 1000.0 / 3.0, seed=5, offset=1)


def _nan_in_image(u, gradu, image):
    image[1, 3, 4] = float("nan")


def _nan_in_u(u, gradu, image):
    u[2, 0, 7] = float("nan")


def _zero_denominator(u, gradu, image):
    # gradu + image == 0 on the crop: -image (x / 0) and 0 with 0 (0 / 0)
    image[0, 5, :] = 0.25
    gradu[0, 5 + 4, 4:-4] = -0.25
    image[1, 6, :] = 0.0
    gradu[1, 6 + 4, 4:-4] = 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("blind", [False, True])
@pytest.mark.parametrize("plant", [_nan_in_image, _nan_in_u, _zero_denominator])
def test_k8_propagates_nan_and_zero_denominators_as_the_ops_on_gpu(plant, blind):
    got = _step_case(_need_gpu(), 3, 48, 72, 40, 64, blind, 1000.0 / 3.0, seed=11, plant=plant)
    assert bool(torch.isnan(got).any())


@pytest.mark.cuda
@pytest.mark.parametrize("blind", [False, True])
def test_k8_on_a_24mp_window_on_gpu(blind):
    """A full-frame window of a 24 MP frame, mk 9, with even sides (the
    pipeline's are odd, as ``certify_kernels`` takes them): every channel
    starts on 16 bytes."""
    _step_case(_need_gpu(), 3, 4012, 6012, 4004, 6004, blind, 1e4, seed=24)


@pytest.mark.cuda
@pytest.mark.parametrize("blind, correlation", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("m, n, mk", [(61, 90, 9), (100, 77, 5)])
def test_the_op_loop_with_k8_is_the_op_loop_on_gpu(m, n, mk, blind, correlation):
    """``inner_loop_ops`` on K1 and K3 with K8 and with the ops: five inner
    steps (and the blind PSF step) bitwise, 10 K8 launches."""
    dev = _need_gpu()
    image, u, psf = _problem(m, n, mk, seed=m * n, device=dev)
    kw = dict(step_factor=1e-3, lambd=1000.0 / 3.0, blind=blind, correlation=correlation,
              conv=conv_planar, psf_grad=psf_gradient_planar)
    before = cuda_step.launches
    got = inner_loop_ops(u.clone(), image, psf, step=cuda_step.mm_step, **kw)
    assert cuda_step.launches == before + 10
    want = inner_loop_ops(u.clone(), image, psf, **kw)
    assert all(_same_bits(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("blind", [False, True])
def test_a_while_solve_with_k8_is_the_python_loop_with_the_ops_on_gpu(monkeypatch, blind):
    """A whole solve through the WHILE graph (K8 in the captured body) and
    the same solve in the host loop, outer by outer, with the PyTorch ops
    in K8's place: the same outers, bitwise the same u and PSF."""
    dev = _need_gpu()
    image, u, psf = _problem(120, 136, 7, seed=3)
    hwc = lambda t: t.permute(1, 2, 0).contiguous()
    args = (hwc(image), hwc(u), hwc(psf), 4, 116, 4, 132)
    kw = dict(tau=1e9, iterations=12, lambd=1000.0 / 3.0, blind=blind,
              config=rl_mm.RLConfig(inner_loop="xla"), device=dev)
    rl_mm.loop_log.clear()
    got = rl_mm.richardson_lucy_MM(*args, **kw)
    entry = rl_mm.loop_log[-1]
    assert entry["route"] == "while" and entry["body_launches"]["k8"] == 10
    monkeypatch.setattr(cuda_step, "mm_step", cuda_step.mm_step_plain)
    rl_mm.loop_log.clear()
    before = cuda_step.launches
    with rl_mm._eager_outer_loop():
        want = rl_mm.richardson_lucy_MM(*args, **kw)
    assert got.iterations == want.iterations
    assert _same_bits(got.u, want.u) and _same_bits(got.psf, want.psf)
    assert cuda_step.launches == before
    assert [(e["route"], e["outers"], e["reads"]) for e in rl_mm.loop_log] == [
        ("host", want.iterations, want.iterations)]
