"""``ics_tpu_torch.bench`` on the CPU against the repository's ``bench.py``
(imported read-only) and ``ics_tpu``: ``_real_image``'s bytes, the per-outer
probe's solve and FLOP model, ``_run_case``'s outer counts, the default
run's JSON line (the measuring functions patched to fixed values, in both
benches), every flag of ``bench.py``'s parser with its routing and exit
code, and the refusal to run on an absent GPU."""

import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import ics_tpu.utils.cache as jcache
from ics_tpu.models.rl_mm import RLConfig as JRLConfig
from ics_tpu.models.rl_mm import richardson_lucy_MM as jrl
from ics_tpu.utils import selftest as jst

from ics_tpu_torch import bench
from ics_tpu_torch.utils import selftest as st
from test_torch_pipeline import CASES
from test_torch_selftest import _place_reference

ROOT = Path(__file__).resolve().parents[1]
PARSED = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", ROOT / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _keys(d: dict, prefix="") -> set:
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_card():
    """Decided here, never at import: the tests that need CUDA absent."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the refusal to run without one cannot show")


@pytest.fixture
def crop_dir(tmp_path):
    import PIL.Image

    PIL.Image.fromarray(st.make_scene(300, 420, 5, seed=8)[1]).save(
        tmp_path / "crop-blured.jpg", quality=95)
    return tmp_path


@pytest.mark.parametrize("shape", [(100, 200), (600, 1100)], ids=["under-512", "tiled"])
@pytest.mark.parametrize("with_images", [False, True], ids=["stand-in", "images"])
def test_real_image_equals_jax(shape, with_images, monkeypatch, crop_dir):
    directory = crop_dir if with_images else None
    _place_reference(monkeypatch, directory)
    got, want = st._real_image(*shape, reference=directory), jst._real_image(*shape)
    assert got.dtype == want.dtype == np.float32 and got.shape == shape + (3,)
    assert np.array_equal(got, want)


def _capture(monkeypatch):
    results = []

    def recording(*a, **k):
        results.append(bench_rl(*a, **k))
        return results[-1]

    bench_rl = bench.richardson_lucy_MM
    monkeypatch.setattr(bench, "richardson_lucy_MM", recording)
    return results


PROBE = dict(m=41, n=61, mk=5, window=(4, 30, 6, 50))


@pytest.mark.parametrize("precision", ["exact", "high"])
def test_probe_matches_jax(precision, monkeypatch, crop_dir):
    """The probe's solve at 41x61, mk 5, on a smooth frame given as the
    reference's crop: exactly ``iters`` outers in each of its calls, u and
    stats within 1e-6 of ``ics_tpu``'s with the same arguments.  (On the
    noise stand-in the epsilon-free DoF division parts the two after a few
    outers: 89 of 7503 values of u differ by up to 0.076 after 3.)"""
    _place_reference(monkeypatch, crop_dir)
    results = _capture(monkeypatch)
    m, n, mk, window, iters = *PROBE.values(), 3
    per_outer, flops = bench._per_outer_probe(iters=iters, reps=2, conv_precision=precision,
                                              device="cpu", reference=crop_dir, **PROBE)
    assert np.isfinite(per_outer) and per_outer > 0
    assert flops == bench.model_flops(m, n, mk) == 5 * 2 * 2 * mk * mk * 3 * m * n
    assert len(results) == 3 and all(r.iterations == iters for r in results)

    pad = mk // 2
    img = jst._real_image(m, n)
    u = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    psf = np.ones((mk, mk, 3), np.float32) / (mk * mk)
    want = jrl(img, u, psf, *window, 1e9, iterations=iters, step_factor=1e-3, lambd=10000.0,
               blind=False, verbose=False, config=JRLConfig(conv_precision=precision))
    assert want.iterations == iters
    for got in results:
        for a, b in [(got.u, want.u), (got.stats, want.stats)]:
            a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
            assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


def test_probe_on_the_stand_in_runs_exactly_iters(monkeypatch):
    _place_reference(monkeypatch, None)
    results = _capture(monkeypatch)
    bench._per_outer_probe(iters=4, reps=1, device="cpu", **PROBE)
    assert len(results) == 2 and all(r.iterations == 4 for r in results)
    assert all(np.isfinite(r.u.numpy()).all() and np.isfinite(r.stats.numpy()).all()
               for r in results)


def test_model_flops_at_the_default_geometry():
    import inspect

    p = inspect.signature(bench._per_outer_probe).parameters
    flops = bench.model_flops(p["m"].default, p["n"].default, p["mk"].default)
    assert (p["m"].default, p["n"].default, p["mk"].default) == (4001, 6001, 9)
    assert round(flops / 1e9, 2) == PARSED["solver_model_gflop_per_outer"] == 116.69


@pytest.mark.parametrize("name", ["blocky", "two-level"])
def test_run_case_outer_counts_equal_bench_py(name, capsys):
    pic, blur_width, kw = CASES[name]
    kw = dict(kw, blur_width=blur_width, verbose=False)
    got = bench._run_case(pic, kw, "t", reps=2, device="cpu")
    assert capsys.readouterr().out == ""  # stdout holds the JSON line only
    want = _root_bench()._run_case(pic, kw, "t")
    assert got[1] == want[1] and got[1] > 0
    assert all(np.isfinite(v) and v > 0 for v in (got[0], got[2]))


def test_run_case_raises_on_a_diverged_level(monkeypatch):
    from ics_tpu_torch.models.rl_mm import RLResult

    monkeypatch.setattr(RLResult, "M_r", property(lambda self: float("nan")))
    pic, blur_width, kw = CASES["blocky"]
    with pytest.raises(RuntimeError, match="diverged"):
        bench._run_case(pic, dict(kw, blur_width=blur_width, verbose=False), "t", device="cpu")


# fixed measurements for both benches' default runs
FIXED = {"bench-24mp": (5.25, 988, 4.5), "bench-24mp-mixed": (5.75, 900, 5.0),
         "bench-24mp-high": (7.5, 1100, 6.75), "bench-1.9mp": (0.25, 120, 0.125)}
PROBES = {"exact": 0.0625, "high": 0.046875}


def _patch_measurements(monkeypatch, module, calls):
    def run_case(pic, kwargs, label, reps=1, device=None):
        calls.append((label, pic.shape, dict(kwargs), reps))
        return FIXED[label]

    def probe(iters=10, reps=3, conv_precision="exact", device=None, **kw):
        return PROBES[conv_precision], bench.model_flops(4001, 6001, 9)

    monkeypatch.setattr(module, "_run_case", run_case)
    monkeypatch.setattr(module, "_per_outer_probe", probe)


def test_default_run_prints_bench_py_keys_and_formulas(monkeypatch, capsys):
    """Both benches' default runs with the same fixed measurements: one
    stdout line each, BENCH_r05.json's key set, equal values except the
    device and its MFU (the port's names the H100's bf16 peak)."""
    _place_reference(monkeypatch, None)
    port_calls, root_calls = [], []
    _patch_measurements(monkeypatch, bench, port_calls)
    device = "NVIDIA H100 80GB HBM3, 700.00 W"
    monkeypatch.setattr(bench, "_device_name", lambda dev: device)
    monkeypatch.setattr(bench, "resolve_device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(bench, "_load", lambda name, shape, reference=None:
                        np.zeros(shape, np.uint8))
    bench.main([])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])

    root = _root_bench()
    _patch_measurements(monkeypatch, root, root_calls)
    monkeypatch.setattr(root, "_load", lambda path, shape: np.zeros(
        (4000, 6000, 3) if "153412" in path else shape, np.uint8))
    monkeypatch.setattr(jcache, "enable_persistent_cache", lambda *a, **k: None)
    monkeypatch.setattr("sys.argv", ["bench.py"])
    root.main()
    want = json.loads(capsys.readouterr().out.splitlines()[-1])

    assert _keys(got) == _keys(PARSED) == _keys(want)
    assert [(c[0], c[1], c[3]) for c in port_calls] == [(c[0], c[1], c[3]) for c in root_calls]
    assert [c[2] for c in port_calls] == [c[2] for c in root_calls]
    assert got["device"] == device
    flops = bench.model_flops(4001, 6001, 9)
    assert got["solver_mfu_pct_of_bf16_peak"] == round(
        flops / PROBES["exact"] / 989e12 * 100, 3)
    assert want["solver_mfu_pct_of_bf16_peak"] is None  # JAX on the CPU names no peak
    skip = {"device", "solver_mfu_pct_of_bf16_peak", "metric"}
    for key in got:
        if key in skip:
            continue
        if isinstance(got[key], dict):
            assert {k: v for k, v in got[key].items() if k != "metric"} == {
                k: v for k, v in want[key].items() if k != "metric"}, key
        else:
            assert got[key] == want[key], key
    assert got["total_outer_iters_24mp"] == 988 and got["elapsed_s"] == 5.25


def _flags(tree) -> set:
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"}


def test_every_bench_py_flag_is_in_the_port():
    want = _flags(ast.parse((ROOT / "bench.py").read_text()))
    got = {a for action in bench._parser()._actions for a in action.option_strings}
    assert want and want <= got
    assert got - want == {"--reference", "--device", "-h", "--help"}


def _exit_code(argv) -> int:
    with pytest.raises(SystemExit) as exc:
        bench.main(argv)
    return exc.value.code


@pytest.mark.parametrize("ok,code", [(True, 0), (False, 1)])
def test_selftest_flag(ok, code, monkeypatch):
    seen = []
    monkeypatch.setattr(st, "certify_kernels", lambda device: seen.append(device) or ok)
    assert _exit_code(["--selftest", "--device", "cpu"]) == code
    assert seen == [torch.device("cpu")]


def test_kernels_flag(monkeypatch):
    seen = []
    monkeypatch.setattr(st, "bench_conv_backends", lambda device: seen.append(device) or {})
    monkeypatch.setattr(st, "certify_kernels", lambda device: pytest.fail("not asked for"))
    assert _exit_code(["--kernels", "--device", "cpu"]) == 0 and len(seen) == 1


SUCCESS_ROWS = [("uniform-5", 0.061234, 0.031234, 0.71234, 0.91234, True),
                ("gauss-5", 0.052345, 0.062345, 0.81234, 0.80123, False)]


@pytest.mark.parametrize("rate,code", [(0.75, 0), (0.5, 1)])
def test_success_rate_flag_matches_bench_py(rate, code, monkeypatch, capsys, tmp_path):
    seen = []
    monkeypatch.setattr(st, "bench_success_rate",
                        lambda **k: seen.append(k) or (rate, SUCCESS_ROWS))
    assert _exit_code(["--success-rate", "--device", "cpu", "--reference", str(tmp_path)]) == code
    assert seen == [{"device": torch.device("cpu"), "reference": str(tmp_path)}]
    got = capsys.readouterr().out
    monkeypatch.setattr(jst, "bench_success_rate", lambda: (rate, SUCCESS_ROWS))
    monkeypatch.setattr(jcache, "enable_persistent_cache", lambda *a, **k: None)
    monkeypatch.setattr("sys.argv", ["bench.py", "--success-rate"])
    with pytest.raises(SystemExit) as exc:
        _root_bench().main()
    assert exc.value.code == code and got == capsys.readouterr().out


QUALITY = {"float32": {"ssim": 0.9564, "psnr": 31.25, "elapsed_s": 5.5, "outers": 988,
                       "ssim_vs_f32": 1.0},
           "high": {"ssim": 0.9561, "psnr": 31.2, "elapsed_s": 7.5, "outers": 1100,
                    "ssim_vs_f32": 0.9998},
           "input": {"ssim": 0.81, "psnr": 25.5}}


def test_precision_quality_flag_matches_bench_py(monkeypatch, capsys):
    monkeypatch.setattr(st, "bench_precision_quality", lambda **k: QUALITY)
    assert _exit_code(["--precision-quality", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    monkeypatch.setattr(jst, "bench_precision_quality", lambda **k: QUALITY)
    monkeypatch.setattr(jcache, "enable_persistent_cache", lambda *a, **k: None)
    monkeypatch.setattr("sys.argv", ["bench.py", "--precision-quality"])
    with pytest.raises(SystemExit) as exc:
        _root_bench().main()
    assert exc.value.code == 0 and got == capsys.readouterr().out
    assert set(json.loads(got)) == {"metric", "value", "unit", "vs_baseline", "modes"}


@pytest.mark.parametrize("flag,device", [([], "cuda"), (["--device", "cuda"], "cuda"),
                                         (["--device", "cpu"], "cpu")])
def test_scaling_flag(flag, device, monkeypatch):
    """One GPU per rank by default, as every entry point; gloo ranks on the
    CPU only with ``--device cpu``."""
    seen = []
    monkeypatch.setattr(st, "bench_scaling", lambda **k: seen.append(k) or {})
    assert _exit_code(["--scaling", "--scaling-shape", "41X61", "--scaling-iters", "2",
                       "--scaling-reps", "1", *flag]) == 0
    assert seen == [dict(m=41, n=61, iterations=2, reps=1, device=device)]
    seen.clear()
    assert _exit_code(["--scaling", *flag]) == 0 and seen == [dict(device=device)]


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"], ["--selftest"], ["--kernels"],
                                  ["--success-rate"], ["--precision-quality"], ["--scaling"]])
def test_cuda_without_a_card_raises(argv, no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(argv)


def test_probe_and_run_case_raise_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        bench._per_outer_probe(iters=1, reps=1, **PROBE)
    pic, blur_width, kw = CASES["blocky"]
    with pytest.raises(RuntimeError, match="cuda"):
        bench._run_case(pic, dict(kw, blur_width=blur_width, verbose=False), "t")


def test_stand_ins_are_the_smoke_scenes(tmp_path, monkeypatch):
    """Without the file, ``_load`` gives chip_smoke.py's scene of that shape;
    with it, the file."""
    assert bench.SCENES == {(4000, 6000): (9, 24), (1367, 1394): (7, 19)}
    small = (40, 48)
    monkeypatch.setitem(bench.SCENES, small, (5, 3))
    got = bench._load("blured.jpg", small + (3,), reference=tmp_path)
    assert np.array_equal(got, st.make_scene(40, 48, 5, seed=3)[1])
    from ics_tpu_torch.utils.io import imsave

    frame = (np.arange(40 * 48 * 3) % 251).astype(np.uint8).reshape(40, 48, 3)
    imsave(str(tmp_path / "blured.tif"), frame)
    assert np.array_equal(bench._load("blured.tif", small + (3,), reference=tmp_path), frame)
