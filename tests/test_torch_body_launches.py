"""``rl_mm.loop_log``'s ``body_launches``: each kernel wrapper's launches over
the capture of one WHILE body, keyed by kernel.  On the CPU a solve takes the
host loop, which captures nothing and logs none; on the card a ``use_tv``
solve's body launches K5 twelve times, a parity-mode one K8 ten times."""

from __future__ import annotations

import pytest
import torch

from ics_tpu_torch.models import rl_mm

def _problem(m=40, mk=5):
    pad = mk // 2
    gen = torch.Generator().manual_seed(m)
    cells = torch.rand((m // 4 + 1, m // 4 + 1, 3), generator=gen) * 0.6 + 0.2
    image = cells.repeat_interleave(4, 0).repeat_interleave(4, 1)[:m, :m].contiguous()
    u = torch.nn.functional.pad(image.permute(2, 0, 1)[None], (pad,) * 4,
                                mode="replicate")[0].permute(1, 2, 0).contiguous()
    psf = torch.full((mk, mk, 3), 1.0 / mk**2)
    return image, u, psf, (pad + 1, m - pad - 1, pad + 1, m - pad - 1)


def test_every_counter_has_its_kernel_key():
    """Each launch counter names its kernel, and no two the same."""
    keys = [key for *_, key in rl_mm._launch_counters()]
    assert len(set(keys)) == len(keys) and {"k1", "k3", "k5", "k7", "k7w", "k8"} <= set(keys)


@pytest.mark.parametrize("use_tv", [False, True])
def test_the_cpu_loop_logs_no_body_launches(use_tv):
    image, u, psf, win = _problem()
    rl_mm.loop_log.clear()
    cfg = rl_mm.RLConfig(use_tv=use_tv)
    rl_mm.richardson_lucy_MM(image, u, psf, *win, tau=1e9, iterations=3, blind=True,
                             config=cfg, device="cpu")
    entry = rl_mm.loop_log[-1]
    assert entry["route"] == "host" and entry["outers"] == 3
    assert entry.get("body_launches") is None


@pytest.mark.cuda
@pytest.mark.parametrize("use_tv, k5", [(False, 0), (True, 12)])
def test_a_while_body_logs_its_launches_on_gpu(use_tv, k5):
    """A blind op-loop solve through the WHILE graph: ``body_launches`` has a
    key per kernel; K5 runs 12 times a body under ``use_tv`` (``tv(ut, 1)``
    and ``tv(ut, 2)`` once, ``tv(u, 1)`` and ``tv(u, 2)`` in each of five
    inner steps), K7 once, K3 five times, and no K7w or K2 inside a body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    image, u, psf, win = _problem()
    rl_mm.loop_log.clear()
    cfg = rl_mm.RLConfig(use_tv=use_tv, inner_loop="xla")
    res = rl_mm.richardson_lucy_MM(image, u, psf, *win, tau=1e9, iterations=6, blind=True,
                                   config=cfg, device="cuda")
    assert res.iterations == 6
    entry = rl_mm.loop_log[-1]
    assert entry["route"] == "while" and entry["k7w"] == 6
    got = entry["body_launches"]
    assert list(got) == [key for *_, key in rl_mm._launch_counters()]
    assert (got["k5"], got["k7"], got["k3"], got["k2"], got["k7w"]) == (k5, 1, 5, 0, 0)
    assert got["k1"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("use_tv, k8", [(False, 10), (True, 0)])
@pytest.mark.parametrize("blind", [False, True])
def test_a_parity_body_launches_k8_on_gpu(blind, use_tv, k8):
    """K8 runs steps 4-8 of each inner step, two launches each, in a
    parity-mode body, blind or not; a ``use_tv`` body keeps the ops."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    image, u, psf, win = _problem()
    rl_mm.loop_log.clear()
    cfg = rl_mm.RLConfig(use_tv=use_tv, inner_loop="xla")
    res = rl_mm.richardson_lucy_MM(image, u, psf, *win, tau=1e9, iterations=6, blind=blind,
                                   config=cfg, device="cuda")
    assert res.iterations == 6
    entry = rl_mm.loop_log[-1]
    assert entry["route"] == "while" and entry["body_launches"]["k8"] == k8
