"""The scene pool, the frames' plan and the kernels' work counts."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import scenes
from benchmark.kernels import k1, k2
from benchmark.roofline import bound_s
from benchmark.run import _plan


def test_scene_pool_is_deterministic():
    a = scenes.pool(48, 64, 5, [1, 2], "cpu")
    b = scenes.pool(48, 64, 5, [1, 2], "cpu")
    assert all(x.dtype == np.uint8 and x.shape == (48, 64, 3) for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], a[1])
    assert 20 < a[0].mean() < 235  # structured content, not saturated


def test_plan_follows_the_seed(tiny):
    seed = 2**31 + 12345
    assert _plan(tiny, seed) == _plan(tiny, seed)
    order, check = _plan(tiny, seed)
    assert sorted(order) == list(range(tiny.mix["pool"]))
    assert len(check) == tiny.config["check"]["frames"]


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_k1_bound():
    """0.1744 ms at 9x9 valid on 3x4012x6012 (PERF.md's kernel table)."""
    ms = bound_s(*k1.work(_meta(3, 4012, 6012), _meta(3, 9, 9), "valid")) * 1e3
    assert ms == pytest.approx(0.1744, abs=5e-5)
    # 'full' needs every input-tap product once: as many as 'valid' of its output
    ops_full, _ = k1.work(_meta(3, 4004, 6004), _meta(3, 9, 9), "full")
    assert ops_full == 2 * 3 * 4004 * 6004 * 81


def test_k2_bound():
    """0.0060 ms for one blind outer on a 262^2 window with mk 7."""
    ms = bound_s(*k2.work(_meta(3, 262, 262), _meta(3, 256, 256), _meta(3, 7, 7),
                          blind=True, step_factor=1e-3)) * 1e3
    assert ms == pytest.approx(0.0060, abs=5e-5)
