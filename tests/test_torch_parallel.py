"""The port's batched deconvolution (``ics_tpu_torch.parallel.batched_deconvolve``)
in one process, against ``ics_tpu.parallel.batched_deconvolve`` on the CPU,
with the shapes and tolerances of tests/test_sharding.py on smooth
content (tests/parallel_fixtures.py).  The multi-rank schedules are in
tests/test_torch_distributed.py."""

import numpy as np
import pytest

import ics_tpu.parallel as jpar
from ics_tpu import richardson_lucy_MM as jrl

import ics_tpu_torch.parallel as tpar
from ics_tpu_torch.models.rl_mm import RLConfig, _solve
from ics_tpu_torch.parallel.tiling import row_counts
from parallel_fixtures import lanes

# eight blind lanes (tests/test_sharding.py:70-96) and four lanes whose
# whiteness stops fall at 25, 25, 3 and 3 outers (:130-202), made smooth
LOOP = lanes(1108, 8, 17, 3)
STOP = lanes(0, 4, 17, 3, contrast=0.2)


def _both(case, schedule, **kw):
    images, us, psfs, box = case
    want = [np.asarray(a) for a in jpar.batched_deconvolve(images, us, psfs, *box,
                                                           schedule=schedule, **kw)]
    got = [a.numpy() for a in tpar.batched_deconvolve(images, us, psfs, *box,
                                                      schedule=schedule, device="cpu", **kw)]
    return got, want


@pytest.mark.parametrize("schedule", ["map", "vmap"])
def test_batched_deconvolve_matches_jax(schedule):
    """Eight blind lanes, two outers: u within 1e-5 and the PSF within 1e-6
    of JAX's lanes under the same schedule."""
    (u, psf, stats), (ju, jpsf, jstats) = _both(
        LOOP, schedule, iterations=2, step_factor=1e-3, lambd=1000.0, blind=True)
    assert u.shape == ju.shape and psf.shape == jpsf.shape and stats.shape == (8, 5)
    np.testing.assert_allclose(u, ju, atol=1e-5)
    np.testing.assert_allclose(psf, jpsf, atol=1e-6)
    np.testing.assert_array_equal(stats[:, 0], jstats[:, 0])


@pytest.fixture(scope="module")
def stop_singles():
    images, us, psfs, box = STOP
    singles = [jrl(images[i], us[i], psfs[i], *box, tau=0.0, iterations=25, step_factor=1e-3,
                   lambd=1000.0, blind=True) for i in range(4)]
    assert len({s.iterations for s in singles}) > 1  # the lanes stop apart
    return singles


@pytest.mark.parametrize("schedule", ["map", "vmap"])
def test_batched_per_lane_stopping_matches_jax(stop_singles, schedule):
    """Each lane stops on its own whiteness test: as many outers as JAX's
    independent solve of it, u within 1e-5, the PSF within 1e-6."""
    (u, psf, stats), (_, _, jstats) = _both(
        STOP, schedule, iterations=25, step_factor=1e-3, lambd=1000.0, blind=True,
        use_stopping=True)
    for i, single in enumerate(stop_singles):
        assert int(stats[i, 0]) == single.iterations == int(jstats[i, 0]), (schedule, i)
        np.testing.assert_allclose(u[i], np.asarray(single.u), atol=1e-5)
        np.testing.assert_allclose(psf[i], np.asarray(single.psf), atol=1e-6)


@pytest.mark.parametrize(
    "blind,cfg",
    [
        (True, dict()),
        (True, dict(psf_grad="conv")),
        (False, dict(use_tv=True, tv_norm="collab")),
        (False, dict(use_tv=True, tv_norm="collab_l2")),
        (False, dict(dtype="mixed")),
        (False, dict(early_stop=0.05, early_stop_patience=2)),
    ],
)
def test_vmap_fold_matches_map(blind, cfg):
    """The fold keeps every lane's own reductions: the collaborative TV
    couplings, the blind PSF maxima and the channel-mean PSF of motion
    blur, the mixed residual and the plateau stop give each lane what its
    own solve gives."""
    images, us, psfs, box = STOP
    kw = dict(iterations=12, step_factor=1e-3, lambd=1000.0, blind=blind, tau=0.01,
              correlation=blind, config=RLConfig(**cfg), device="cpu")
    mapped = tpar.batched_deconvolve(images, us, psfs, *box, schedule="map", **kw)
    folded = tpar.batched_deconvolve(images, us, psfs, *box, schedule="vmap", **kw)
    np.testing.assert_array_equal(folded[2][:, :2].numpy(), mapped[2][:, :2].numpy())
    np.testing.assert_allclose(folded[0].numpy(), mapped[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(folded[1].numpy(), mapped[1].numpy(), atol=1e-7)


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(schedule="shard_map"), "requires a mesh"),
        (dict(schedule="scan"), "unknown schedule"),
    ],
)
def test_batched_validations(kw, match):
    images, us, psfs, box = STOP
    for fn, extra in ((jpar.batched_deconvolve, {}),
                      (tpar.batched_deconvolve, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            fn(images, us, psfs, *box, **kw, **extra)


def test_batch_record_metrics_raises():
    images, us, psfs, box = STOP
    import torch

    t = lambda a: torch.from_numpy(a)
    with pytest.raises(ValueError, match="one image"):
        _solve(t(images), t(us), t(psfs), np.ones((13, 13), np.float32), top=box[0],
               bottom=box[1], left=box[2], right=box[3], tau=0.0, step_factor=1e-3,
               lambd=1000.0, iterations=2, blind=True, correlation=False, record=True)


def test_parallel_exports_the_jax_names():
    assert sorted(tpar.__all__) == sorted(jpar.__all__)
    assert (tpar.TILE_AXIS, tpar.BATCH_AXIS) == (jpar.TILE_AXIS, jpar.BATCH_AXIS)


@pytest.mark.parametrize("rows,ranks", [(63, 4), (67, 4), (16, 4), (5, 2)])
def test_row_counts_split_evenly(rows, ranks):
    counts = row_counts(rows, ranks)
    assert sum(counts) == rows and max(counts) - min(counts) <= 1
    assert counts == sorted(counts, reverse=True)
