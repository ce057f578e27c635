"""``ics_tpu_torch.utils.selftest`` on the CPU: the battery helpers give the
JAX package's bytes, on its stand-ins and on a directory of reference
images, the success battery runs through the port's pipeline, the scaling
bench runs gloo ranks, and the kernel certification and the conv bench
refuse to run without a GPU.

The JAX file reads the reference's images from fixed paths when they are
there; each test here puts that directory in one place for both packages
(nowhere, or a directory of synthetic images that the port gets as its
``reference`` argument), so that what the host holds changes nothing."""

import os
from pathlib import Path

import numpy as np
import pytest

from ics_tpu.utils import selftest as jst

from ics_tpu_torch.utils import selftest as st


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the 64^2 solves are launch-bound, and the suite's
    parallel workers oversubscribe the cores otherwise."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _place_reference(monkeypatch, directory):
    """Point the JAX file's reference images at ``directory`` (None: no
    images), through ``os.path.exists`` and ``PIL.Image.open``."""
    import PIL.Image

    exists, open_image = os.path.exists, PIL.Image.open

    def redirect(path):
        p = Path(os.fspath(path))
        if p.parent.as_posix().endswith("reference/img"):
            return None if directory is None else directory / p.name
        return path

    def fake_exists(path):
        target = redirect(path)
        return target is not None and exists(target)

    monkeypatch.setattr(os.path, "exists", fake_exists)
    monkeypatch.setattr(PIL.Image, "open", lambda path, *a, **k: open_image(redirect(path), *a, **k))


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Synthetic reference images: a sharp scene and its blurred twin,
    large enough for ``_fitted_kernel``'s sample grid (rows and columns up
    to 679)."""
    import PIL.Image

    directory = tmp_path_factory.mktemp("images")
    sharp, blurred = st.make_scene(704, 720, 5, seed=21)
    PIL.Image.fromarray((sharp * 255).round().astype(np.uint8)).save(directory / "original.jpg",
                                                                     quality=95)
    PIL.Image.fromarray(blurred).save(directory / "blured.jpg", quality=95)
    return directory


@pytest.fixture
def stand_in(monkeypatch):
    """No reference images for either package: both use their stand-ins."""
    _place_reference(monkeypatch, None)


@pytest.fixture(params=["stand-in", "images"])
def reference(request, monkeypatch, image_dir):
    """The reference images' directory, for the port's ``reference``
    argument; the JAX file sees the same."""
    directory = None if request.param == "stand-in" else image_dir
    _place_reference(monkeypatch, directory)
    return directory


def test_all_names_the_jax_functions_and_the_precision_bench():
    assert set(st.__all__) == set(jst.__all__) | {"bench_precision_quality"}
    assert callable(jst.bench_precision_quality)


def test_success_battery_equals_jax(reference):
    got, want = st.make_success_battery(reference=reference), jst.make_success_battery()
    assert [(n, s) for n, _, s in got] == [(n, s) for n, _, s in want]
    for (name, psf, _), (_, ref, _) in zip(got, want):
        assert psf.dtype == ref.dtype and psf.shape == ref.shape, name
        assert np.array_equal(psf, ref), name


@pytest.mark.parametrize("size,seed", [(7, 5), (9, 6), (5, 1)])
def test_blob_kernel_equals_jax(size, seed):
    got, want = st._blob_kernel(size, seed), jst._blob_kernel(size, seed)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


def test_fitted_kernel_equals_jax(reference):
    got, want = st._fitted_kernel(reference), jst._fitted_kernel()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # the images' case fits the kernel; the stand-in's is the blob
    assert np.array_equal(got, jst._blob_kernel(7, 5)) == (reference is None)


@pytest.mark.parametrize("size", [96, 40])
def test_sharp_crop_equals_jax(size, reference):
    got, want = st._sharp_crop(size, reference), jst._sharp_crop(size)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    assert np.array_equal(got, want)


def test_sharp_frame_equals_jax(reference):
    got = st._sharp_frame(reference=reference)
    assert np.array_equal(got, jst._sharp_frame())
    assert got.shape == ((512, 512, 3) if reference is None else (704, 720, 3))


@pytest.mark.parametrize("case", [0, 4, 9, 11])  # uniform-5, blob-9, fitted-7-noise, motion-9-45
def test_synth_blur_case_and_rel_error_equal_jax(case, reference):
    sharp = st._sharp_crop(96, reference)
    name, psf, noise = st.make_success_battery(reference=reference)[case]
    got = st.synth_blur_case(sharp, psf, noise)
    want = jst.synth_blur_case(sharp, psf, noise)
    assert got.dtype == np.uint8 and np.array_equal(got, want), name
    out16 = got.astype(np.uint16) * 257
    assert abs(st.rel_error(out16, sharp) - jst.rel_error(out16, sharp)) <= 1e-12


def test_success_rate_on_the_cpu():
    lines = []
    rate, rows = st.bench_success_rate(size=64, iterations=2, mask_size=31, device="cpu",
                                       report=lines.append)
    assert len(rows) == 12 and [r[0] for r in rows] == [n for n, _, _ in st.make_success_battery()]
    for name, in_err, err, in_ssim, out_ssim, success in rows:
        assert all(np.isfinite([in_err, err, in_ssim, out_ssim])), name
        assert success == (err < 0.05 and out_ssim > in_ssim)
    assert rate == sum(r[-1] for r in rows) / 12 and lines[-1].startswith("[success] rate")


def test_success_rate_lets_a_solve_error_through(monkeypatch):
    """A diverged solve is no exception in the port; any error the solve
    raises (a kernel's fault, a failed build) ends the battery."""
    from ics_tpu_torch.models import pipeline

    def fault(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal instruction was encountered")

    monkeypatch.setattr(pipeline, "deblur_module", fault)
    with pytest.raises(RuntimeError, match="illegal instruction"):
        st.bench_success_rate(size=32, iterations=1, mask_size=15, device="cpu",
                              report=lambda line: None)


def test_scaling_bench_on_gloo_ranks():
    lines = []
    got = st.bench_scaling(m=45, n=61, mk=5, iterations=2, ns=(1, 2, 10**6), reps=1,
                           device="cpu", report=lines.append)
    assert set(got) == {1, 2} and all(v > 0 for v in got.values())
    assert lines[-1] == f"[scaling] n={10**6}: skipped (only {os.cpu_count()} CPU cores)"


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("bench", ["certify_kernels", "bench_conv_backends"])
def test_kernel_benches_need_a_gpu(bench, device):
    """The kernels have no CPU path: no fallback hides a missing card."""
    import torch

    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="cuda|GPU"):
        getattr(st, bench)(device=device, report=lambda line: None)


def test_make_scene_is_structured_and_seeded():
    sharp, pic = st.make_scene(48, 64, 5, seed=3)
    assert sharp.dtype == np.float32 and pic.dtype == np.uint8 and pic.shape == (48, 64, 3)
    assert 0.15 <= sharp.min() and sharp.max() <= 0.9
    assert np.array_equal(pic, st.make_scene(48, 64, 5, seed=3)[1])


def test_precision_truth_is_the_full_24mp_frame(stand_in):
    """The stand-in truth fills 4000x6000 (the JAX file's own tiles stop at
    3072 columns, where the 24 MP mask does not fit); where both exist it
    is JAX's frame."""
    got = st._precision_truth()
    assert got.shape == (4000, 6000, 3) and got.dtype == np.uint8
    want = np.tile(jst._sharp_frame(), (8, 6, 1))[:4000, :6000]
    assert np.array_equal(got[:, : want.shape[1]], want)
