"""The port's multi-rank paths (``ics_tpu_torch.parallel``, ``deblur_module(
mesh=...)``, the CLI's ``--shard`` and ``deblur-batch``) on gloo CPU
processes, against ``ics_tpu.parallel`` on the conftest's virtual devices,
with the shapes and tolerances of tests/test_sharding.py on smooth content
(tests/parallel_fixtures.py).

Each world size starts its ranks once (tests/_torch_parallel_worker.py, which
imports torch and the port only) and runs every case; the tests read the
results.  The groups and the CLI process start together, and each has a
hard deadline that kills it.
"""

import contextlib
import io
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig

from ics_tpu import deblur_module, richardson_lucy_MM
from ics_tpu.cli import main as jmain
from ics_tpu.models.checkpoint import SolverCheckpoint, save_checkpoint
from ics_tpu.models.rl_mm import RLConfig
from ics_tpu.ops.windows import gaussian_kernel, uniform_kernel
from ics_tpu.parallel import (
    batched_deconvolve,
    make_mesh,
    make_mesh_2d,
    sharded_convolve_rgb,
    sharded_richardson_lucy,
)
from ics_tpu.utils.io import imread, imsave
from ics_tpu.utils.metrics import ssim

from parallel_fixtures import lanes, padded, smooth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
DEADLINE_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start_ranks(directory, world):
    """Start ``world`` worker ranks on the inputs in ``directory``."""
    port = _free_port()
    return [
        subprocess.Popen([sys.executable, WORKER, str(directory), str(port), str(r), str(world)],
                         env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)
    ]


def _wait(procs, what):
    """Wait for every process of a group, or kill them all at the deadline;
    returns their (stdout, stderr)."""
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=DEADLINE_S))
    except subprocess.TimeoutExpired:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        pytest.fail(f"{what} exceeded the {DEADLINE_S} s deadline")
    return outs


def _inputs():
    rng = np.random.default_rng(2108)
    out = {}
    out["conv_image"] = rng.random((64, 40, 3)).astype(np.float32)
    out["conv_kernel"] = np.dstack([gaussian_kernel(5, 1.2)] * 3).astype(np.float32)
    # m = 63 over 4 ranks: uneven splits of both u (67 rows) and the image
    mk, m = 5, 63
    image = smooth(rng, m, m).astype(np.float32)
    out["smooth_image"] = image
    out["smooth_u"] = padded(image[None], mk // 2)[0]
    out["smooth_psf"] = np.dstack([uniform_kernel(mk)] * 3).astype(np.float32)
    # the 2-D mesh case (b 2, m 16, mk 3) and the per-lane stopping lanes
    out["b2d_images"], out["b2d_us"], out["b2d_psfs"], _ = lanes(16, 2, 16, 3)
    out["stop_images"], out["stop_us"], out["stop_psfs"], _ = lanes(0, 4, 17, 3, contrast=0.2)
    out["pipe_pic"] = (smooth(rng, 61, 65) * 255).astype(np.uint8)
    return out


INPUTS = _inputs()


_CLI = r"""
import sys
from ics_tpu_torch.cli import main
d = sys.argv[1]
base = ["--iterations", "20", "--mask-size", "31", "--psf", d + "/psf.npz"]
main(["deblur", d + "/in.tif", d + "/t_deblur", "--blur-width", "3", "--iterations", "4",
      "--mask-size", "25", "--shard", "2"], device="cpu")
main(["deblur-batch", d + "/f*.tif", d + "/t_batch", *base], device="cpu")
main(["deblur-batch", d + "/f*.tif", d + "/t_batch2", *base, "--shard", "2"], device="cpu")
print("CLI-OK")
"""


def _cli_inputs(d):
    """A 64x64 TIFF, a burst of four 16-bit frames and a PSF checkpoint."""
    rng = np.random.default_rng(81)
    frame = lambda: np.clip(np.kron(60 + 140 * rng.random((8, 8, 3)), np.ones((8, 8, 1))),
                            0, 255).astype(np.uint8)
    imsave(str(d / "in.tif"), frame())
    for i in range(4):
        imsave(str(d / f"f{i}.tif"), frame().astype(np.uint16) * 257)
    save_checkpoint(str(d / "psf.npz"),
                    SolverCheckpoint(psf=np.dstack([gaussian_kernel(5, 1.0)] * 3)))


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every group starts at once: 4 ranks, 2 ranks, and the port's CLI as
    one process that starts its own ranks."""
    started = {}
    for world in (4, 2):
        d = tmp_path_factory.mktemp(f"world{world}")
        for name, arr in INPUTS.items():
            np.save(d / f"in_{name}.npy", arr)
        started[world] = (d, _start_ranks(d, world))
    d = tmp_path_factory.mktemp("cli")
    _cli_inputs(d)
    started["cli"] = (d, [subprocess.Popen([sys.executable, "-c", _CLI, str(d)], env=_env(),
                                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True)])
    yield started
    for _, procs in started.values():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _world(groups, world):
    d, procs = groups[world]
    for r, (proc, (out, err)) in enumerate(zip(procs, _wait(procs, f"{world} ranks"))):
        assert proc.returncode == 0 and f"RANK{r}-OK" in out, f"rank {r} failed:\n{err[-3000:]}"
    return d


@pytest.fixture(scope="module")
def world4(groups):
    return _world(groups, 4)


@pytest.fixture(scope="module")
def world2(groups):
    return _world(groups, 2)


def _read(d, case, world):
    return [dict(np.load(d / f"{case}_r{r}.npz")) for r in range(world)]


def _box(m, pad):
    return pad + 1, m - pad - 1, pad + 1, m - pad - 1


def _centred(m, size):
    top = m // 2 - size // 2
    return top, top + size, top, top + size


def test_sharded_convolve_matches_jax(world4):
    img, kern = INPUTS["conv_image"], INPUTS["conv_kernel"]
    want = np.asarray(sharded_convolve_rgb(jnp.asarray(img), jnp.asarray(kern), make_mesh(4)))
    ranks = _read(world4, "convolve", 4)
    got = np.concatenate([r["block"] for r in ranks])
    np.testing.assert_allclose(got, want, atol=2e-4)
    for c in range(3):
        ref = sig.convolve(img[..., c], kern[..., c], mode="same")
        np.testing.assert_allclose(got[..., c], ref, atol=2e-4)
    assert all(np.array_equal(r["whole"], got) for r in ranks)


def _jax_sharded(**kw):
    image, u, psf = INPUTS["smooth_image"], INPUTS["smooth_u"], INPUTS["smooth_psf"]
    return sharded_richardson_lucy(image, u, psf, *_box(63, 2), 0.0, mesh=make_mesh(4),
                                   iterations=3, step_factor=1e-3, lambd=1000.0, blind=True,
                                   config=RLConfig(record_metrics=True))


def test_sharded_solver_matches_jax_and_single_device(world4):
    """Blind, m = 63 over 4 ranks: u within 5e-5 and the PSF within 5e-6 of
    JAX's sharded solve and of the port on one device."""
    want = _jax_sharded()
    got = _read(world4, "sharded", 4)[0]
    for ref_u, ref_psf in ((np.asarray(want.u), np.asarray(want.psf)),
                           (got["single_u"], got["single_psf"])):
        np.testing.assert_allclose(got["u"], ref_u, atol=5e-5)
        np.testing.assert_allclose(got["psf"], ref_psf, atol=5e-6)
    np.testing.assert_allclose(got["stats"], np.asarray(want.stats), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["u_full"], np.asarray(want.u_full), atol=5e-5)


def test_sharded_solver_records_metrics(world4):
    want = _jax_sharded()
    got = _read(world4, "sharded", 4)[0]
    assert len(got["traj_M_r"]) == int(got["stats"][0]) == want.iterations
    for key in ("M_r", "Hu", "varu"):
        np.testing.assert_allclose(got[f"traj_{key}"], want.trajectory[key], rtol=1e-5)
        np.testing.assert_allclose(got[f"traj_{key}"], got[f"single_traj_{key}"], rtol=1e-6)


def test_sharded_solver_is_reproducible_and_replicated(world4):
    ranks = _read(world4, "sharded", 4)
    for key in ("u", "psf", "stats", "u_full", "image"):
        assert np.array_equal(ranks[0][key], ranks[0][f"again_{key}"]), key
        for r in ranks[1:]:
            assert np.array_equal(r[key], ranks[0][key]), key


def test_sharded_solver_centred_window(world4):
    """A mask window centred in the frame (the first rank's rows wholly
    above it, the last rank's wholly below), m = 63 over 4 ranks: u within
    5e-5 and the PSF within 5e-6 of JAX's sharded solve and of one device,
    the same recorded metrics, and every rank the same bits."""
    image, u, psf = INPUTS["smooth_image"], INPUTS["smooth_u"], INPUTS["smooth_psf"]
    want = sharded_richardson_lucy(image, u, psf, *_centred(63, 21), 0.0, mesh=make_mesh(4),
                                   iterations=3, step_factor=1e-3, lambd=1000.0, blind=True,
                                   config=RLConfig(record_metrics=True))
    ranks = _read(world4, "window", 4)
    got = ranks[0]
    for ref_u, ref_psf in ((np.asarray(want.u), np.asarray(want.psf)),
                           (got["single_u"], got["single_psf"])):
        np.testing.assert_allclose(got["u"], ref_u, atol=5e-5)
        np.testing.assert_allclose(got["psf"], ref_psf, atol=5e-6)
    np.testing.assert_allclose(got["stats"], np.asarray(want.stats), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["stats"], got["single_stats"], rtol=1e-5, atol=1e-6)
    for key in ("M_r", "Hu", "varu"):
        np.testing.assert_allclose(got[f"traj_{key}"], want.trajectory[key], rtol=1e-5)
    for r in ranks[1:]:
        assert all(np.array_equal(r[k], got[k]) for k in got), "ranks differ"


def test_batched_tile4_centred_window_matches_jax(world4):
    """A (batch 1, tile 4) mesh with deblur-batch's centred mask: JAX's
    (batch 1, tile 4) case within u 1e-5 and PSF 1e-6, and the port's
    one-device 'vmap' as well."""
    images, us, psfs = INPUTS["b2d_images"], INPUTS["b2d_us"], INPUTS["b2d_psfs"]
    u_b, psf_b, stats_b = batched_deconvolve(images, us, psfs, *_centred(16, 7), iterations=2,
                                             blind=True, mesh=make_mesh_2d(tile=4, batch=1))
    ranks = _read(world4, "tile4", 4)
    got = ranks[0]
    for ref_u, ref_psf in ((np.asarray(u_b), np.asarray(psf_b)),
                           (got["single_u"], got["single_psf"])):
        np.testing.assert_allclose(got["u"], ref_u, atol=1e-5)
        np.testing.assert_allclose(got["psf"], ref_psf, atol=1e-6)
    np.testing.assert_allclose(got["stats"], np.asarray(stats_b), rtol=1e-5, atol=1e-6)
    assert all(np.array_equal(r["u"], got["u"]) for r in ranks[1:])


@pytest.mark.parametrize("mode", ["tv_collab", "mixed", "high", "motion"])
def test_sharded_modes_match_single_device(world4, mode):
    """The halo and reduction of each mode: TV stencils (one row of halo,
    the collaborative coupling), the mixed residual's bf16 increments, the
    split convolution and motion blur's channel-mean PSF."""
    got = _read(world4, "modes", 4)[0]
    np.testing.assert_allclose(got[f"{mode}_u"], got[f"{mode}_single_u"], atol=5e-5)
    np.testing.assert_allclose(got[f"{mode}_psf"], got[f"{mode}_single_psf"], atol=5e-6)
    np.testing.assert_allclose(got[f"{mode}_stats"][:2], got[f"{mode}_single_stats"][:2])


def test_batched_tiled_2d_mesh_matches_jax(world4):
    images, us, psfs = INPUTS["b2d_images"], INPUTS["b2d_us"], INPUTS["b2d_psfs"]
    u_b, psf_b, _ = batched_deconvolve(images, us, psfs, *_box(16, 1), iterations=2,
                                       blind=True, mesh=make_mesh_2d(tile=4, batch=2))
    ranks = _read(world4, "batch_2d", 4)
    np.testing.assert_allclose(ranks[0]["u"], np.asarray(u_b), atol=1e-5)
    np.testing.assert_allclose(ranks[0]["psf"], np.asarray(psf_b), atol=1e-6)
    single = richardson_lucy_MM(images[1], us[1], psfs[1], *_box(16, 1), tau=0.0,
                                iterations=2, step_factor=1e-3, lambd=10000.0, blind=True)
    np.testing.assert_allclose(ranks[0]["u"][1], np.asarray(single.u), atol=1e-5)
    assert all(np.array_equal(r["u"], ranks[0]["u"]) for r in ranks[1:])


@pytest.fixture(scope="module")
def jax_stopping():
    images, us, psfs = INPUTS["stop_images"], INPUTS["stop_us"], INPUTS["stop_psfs"]
    singles = [richardson_lucy_MM(images[i], us[i], psfs[i], *_box(17, 1), tau=0.0,
                                  iterations=25, step_factor=1e-3, lambd=1000.0, blind=True)
               for i in range(4)]
    assert len({s.iterations for s in singles}) > 1  # the lanes stop apart
    return singles


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("schedule", ["shard_map", "vmap"])
def test_batched_lanes_over_a_batch_mesh(request, jax_stopping, world, schedule):
    """Lanes split over a 1-D batch mesh of 2 or 4 ranks: each lane stops
    after as many outers as JAX's independent solve."""
    got = _read(request.getfixturevalue(f"world{world}"), "stopping", world)
    for i, single in enumerate(jax_stopping):
        assert int(got[0][f"{schedule}_stats"][i, 0]) == single.iterations, i
        np.testing.assert_allclose(got[0][f"{schedule}_u"][i], np.asarray(single.u), atol=1e-5)
        np.testing.assert_allclose(got[0][f"{schedule}_psf"][i], np.asarray(single.psf),
                                   atol=1e-6)
    for r in got[1:]:
        assert np.array_equal(r[f"{schedule}_u"], got[0][f"{schedule}_u"])


@pytest.mark.parametrize(
    "key,match",
    [("whole", "whole on one device"), ("divide", "must divide"),
     ("slice6", "must be divisible"), ("pam", "only supported by the 'mm' solver")],
)
def test_mesh_validations(world4, key, match):
    for r in _read(world4, "validations", 4):
        assert match in str(r[key]), str(r[key])


def test_local_batch_slice(world4):
    for rank, r in enumerate(_read(world4, "validations", 4)):
        assert list(r["slice8"]) == [2 * rank, 2 * rank + 2]


def test_pipeline_mesh_matches_jax(world4):
    """deblur_module(mesh=...) on 4 ranks: SSIM >= 0.999 against JAX's
    deblur_module(mesh=make_mesh(4)), within one 16-bit code of the port on
    one device; every rank's array and blind PSFs are the same bits."""
    pic = INPUTS["pipe_pic"]
    with contextlib.redirect_stdout(io.StringIO()):
        want = deblur_module(pic, "t", None, blur_width=5, mask=[30, 32], mask_size=31,
                             tolerance=0.1, iterations=3, verbose=False, mesh=make_mesh(4))
    ranks = _read(world4, "pipeline", 4)
    got = ranks[0]["sharded"]
    assert got.dtype == np.uint16 and got.shape == want.shape
    assert ssim(got / 65535.0, want / 65535.0) >= 0.999
    assert np.abs(got.astype(np.int32) - ranks[0]["single"]).max() <= 1
    assert any(k.startswith("blind_psf") for k in ranks[0])
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        assert all(np.array_equal(r[k], ranks[0][k]) for k in r if k != "single")


@pytest.fixture(scope="module")
def cli_runs(groups):
    """The port's CLI on the 64x64 TIFF and the burst; JAX's CLI on the same
    files."""
    d, procs = groups["cli"]
    ((out, err),) = _wait(procs, "the CLI")
    assert procs[0].returncode == 0 and "CLI-OK" in out, err[-3000:]
    with contextlib.redirect_stdout(io.StringIO()):
        assert jmain(["deblur", str(d / "in.tif"), str(d / "j_deblur"), "--blur-width", "3",
                      "--iterations", "4", "--mask-size", "25"]) == 0
        assert jmain(["deblur-batch", str(d / "f*.tif"), str(d / "j_batch"), "--iterations",
                      "20", "--mask-size", "31", "--psf", str(d / "psf.npz")]) == 0
    return d, out


def test_cli_deblur_shard_matches_jax(cli_runs):
    d, _ = cli_runs
    got, want = (imread(str(d / x / "in-deblurred.tif")) for x in ("t_deblur", "j_deblur"))
    assert got.dtype == np.uint16 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want).max() <= 1


@pytest.mark.parametrize("out", ["t_batch", "t_batch2"])
def test_cli_deblur_batch_matches_jax(cli_runs, out):
    """``deblur-batch`` alone and over 2 ranks (``--shard 2``): every frame
    within one 16-bit code of ics_tpu's CLI; one line per frame."""
    d, stdout = cli_runs
    for i in range(4):
        got = imread(str(d / out / f"f{i}-deblurred.tif"))
        want = imread(str(d / "j_batch" / f"f{i}-deblurred.tif"))
        assert got.dtype == np.uint16 and got.shape == want.shape
        assert np.abs(got.astype(np.int32) - want).max() <= 1
    assert stdout.count("f0-deblurred: ") == 2
