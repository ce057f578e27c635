"""The port's surface against the JAX package's: every name in the
``__all__`` of every ``ics_tpu`` module has its counterpart in the port's
module at the same path (a Pallas kernel module's in its CUDA kernel
module), except the TPU-only names listed with their reasons; then the
names that came last (the reductions, ``normalize_kernel_np``,
``profile_trace``, ``block_and_time``, ``enable_persistent_cache``) against
their JAX twins."""

import importlib
import importlib.util
import inspect
import os
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ics_tpu
from ics_tpu.ops import psf as jpsf
from ics_tpu.ops import reductions as jred
from ics_tpu.utils import cache as jcache
from ics_tpu.utils import trace as jtrace

from ics_tpu_torch import _build
from ics_tpu_torch.ops import psf as tpsf
from ics_tpu_torch.ops import reductions as tred
from ics_tpu_torch.utils import cache as tcache
from ics_tpu_torch.utils import trace as ttrace

# a Pallas kernel module -> the CUDA kernel module that replaces it
MODULES = {
    "ics_tpu.ops.pallas_conv": "ics_tpu_torch.ops.cuda_conv",
    "ics_tpu.ops.pallas_conv_mxu": "ics_tpu_torch.ops.cuda_conv_mma",
    "ics_tpu.ops.pallas_correlate": "ics_tpu_torch.ops.cuda_correlate",
    "ics_tpu.ops.pallas_solver": "ics_tpu_torch.ops.cuda_solver",
    "ics_tpu.ops.pallas_tv": "ics_tpu_torch.ops.cuda_tv",
    "ics_tpu.ops.pallas_bilateral": "ics_tpu_torch.ops.cuda_bilateral",
}
# a Pallas kernel's entry -> the port's: the kernels take the planar
# (C, H, W) layout their callers hold; conv_rgb_mxu keeps (H, W, C)
NAMES = {
    ("ics_tpu.ops.pallas_conv", "conv_rgb_pallas"): "conv_planar",
    ("ics_tpu.ops.pallas_conv_mxu", "conv_rgb_pallas_mxu"): "conv_rgb_mxu",
    ("ics_tpu.ops.pallas_solver", "inner_loop_pallas"): "inner_loop_planar",
    ("ics_tpu.ops.pallas_tv", "tv_op_pallas"): "tv_planar",
    ("ics_tpu.ops.pallas_bilateral", "bilateral_pallas"): "bilateral_planar",
}
# names that exist only for the TPU, each with its reason
TPU_ONLY = {
    "mxu_tile_h": "the MXU kernel's row tile under the scoped-VMEM budget; "
                  "cuda_conv_mma.geometry sizes K4's tiles in shared memory",
    "tv_tile_h": "the TV kernel's row tile under the scoped-VMEM budget; K5 tiles "
                 "have a fixed size",
    "bilateral_tile_h": "the bilateral kernel's row tile under the scoped-VMEM budget; "
                        "K6 tiles have a fixed size",
    "fits_vmem": "the VMEM bound of the one-kernel inner loop; the port's bound of K2 "
                 "is cuda_solver.fits",
    "unroll_fits": "the VMEM bound of the unrolled inner-loop kernel, which the port "
                   "runs as K2",
}


def _jax_modules() -> list[str]:
    """Every Python module of ``ics_tpu`` that declares ``__all__``."""
    names = ["ics_tpu"]
    for info in pkgutil.walk_packages(ics_tpu.__path__, "ics_tpu."):
        origin = importlib.util.find_spec(info.name).origin or ""
        if origin.endswith(".py"):
            names.append(info.name)
    return sorted(n for n in names if hasattr(importlib.import_module(n), "__all__"))


JAX_MODULES = _jax_modules()


def test_the_walk_finds_every_module_with_a_surface():
    for name in ("ics_tpu", "ics_tpu.ops.conv", "ics_tpu.ops.pallas_conv_mxu",
                 "ics_tpu.utils.cache", "ics_tpu.utils.trace", "ics_tpu.parallel"):
        assert name in JAX_MODULES
    for (module, name), _ in NAMES.items():
        assert name in importlib.import_module(module).__all__
    found = {n for m in JAX_MODULES for n in importlib.import_module(m).__all__}
    assert set(TPU_ONLY) <= found


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_exports_every_jax_name(module):
    port = importlib.import_module(MODULES.get(module, module.replace("ics_tpu", "ics_tpu_torch", 1)))
    missing = []
    for name in importlib.import_module(module).__all__:
        if name in TPU_ONLY:
            continue
        ported = NAMES.get((module, name), name)
        if ported not in port.__all__ or not hasattr(port, ported):
            missing.append(f"{name} -> {port.__name__}.{ported}")
    assert not missing, missing


# ------------------------------------------------------------- reductions
@pytest.mark.parametrize("name", ["mean", "variance", "amax", "amaxabs", "array_norm_L1",
                                  "array_norm_L2"])
def test_reductions_match_jax(name):
    a = np.random.default_rng(3).standard_normal((37, 41, 3)).astype(np.float32)
    want = float(getattr(jred, name)(jnp.asarray(a)))
    got = getattr(tred, name)(torch.from_numpy(a))
    assert got.ndim == 0 and got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1.0)


def test_variance_takes_a_given_mean_as_jax_does():
    a = np.random.default_rng(4).random((20, 30)).astype(np.float32)
    want = float(jred.variance(jnp.asarray(a), jnp.float32(0.25)))
    got = float(tred.variance(torch.from_numpy(a), torch.tensor(0.25)))
    assert abs(got - want) <= 1e-6 * want


def test_normalize_kernel_np_matches_jax():
    rng = np.random.default_rng(5)
    for shape in ((7, 7), (9, 9, 3)):
        k = rng.standard_normal(shape)
        np.testing.assert_array_equal(tpsf.normalize_kernel_np(k), jpsf.normalize_kernel_np(k))


# ---------------------------------------------------------------- tracing
def test_block_and_time_returns_the_result_and_its_seconds():
    x = torch.arange(12.0).reshape(3, 4)

    def fn(a, scale=1.0):
        return a * scale, {"sum": a.sum()}, [a.max()]

    got, seconds = ttrace.block_and_time(fn, x, scale=2.0)
    want, jseconds = jtrace.block_and_time(lambda a, scale: (a * scale, {"sum": a.sum()},
                                                              [a.max()]),
                                           jnp.asarray(x.numpy()), scale=2.0)
    assert seconds >= 0.0 and jseconds >= 0.0
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert float(got[1]["sum"]) == float(want[1]["sum"])
    assert float(got[2][0]) == float(want[2][0])
    assert inspect.signature(ttrace.block_and_time).parameters.keys() == \
        inspect.signature(jtrace.block_and_time).parameters.keys()


def test_profile_trace_writes_a_trace_file(tmp_path):
    logdir = tmp_path / "trace"
    with ttrace.profile_trace(str(logdir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for _, _, fs in os.walk(logdir) for f in fs]
    assert any(f.endswith(".pt.trace.json") for f in files), files


# ------------------------------------------------------------------ cache
def test_enable_persistent_cache_has_the_jax_signature_and_default():
    assert inspect.signature(tcache.enable_persistent_cache).parameters.keys() == \
        inspect.signature(jcache.enable_persistent_cache).parameters.keys()
    assert inspect.signature(tcache.enable_persistent_cache).parameters[
        "min_compile_secs"].default == 1.0
    assert inspect.signature(tcache.enable_persistent_cache).parameters["path"].default is None
    assert tcache.DEFAULT_CACHE_DIR == str(_build.DEFAULT_BUILD_DIR)
    assert _build.DEFAULT_BUILD_DIR == \
        __import__("pathlib").Path(_build.__file__).resolve().parent / "_build"


_CACHE_CHILD = """
import sys
from pathlib import Path
from ics_tpu_torch import _build
from ics_tpu_torch.runtime import _lib
from ics_tpu_torch.utils import enable_persistent_cache
first, other = Path(sys.argv[1]), Path(sys.argv[2])
enable_persistent_cache(str(first), min_compile_secs=0.0)
assert _build.build_dir() == first
enable_persistent_cache()  # as the CLI calls it: the caller's directory stays
assert _build.build_dir() == first
lib = _lib.load()
assert Path(lib._name).resolve().is_relative_to(first.resolve()), lib._name
enable_persistent_cache(str(first))  # the directory in use: nothing to do
try:
    enable_persistent_cache(str(other))
except RuntimeError as exc:
    assert "loaded" in str(exc)
    print("took", lib._name)
else:
    raise SystemExit("no error after the runtime was loaded")
"""


def test_enable_persistent_cache_takes_the_build_directory(tmp_path):
    """In a fresh process: the C++ runtime builds into the directory named,
    a call without a path (the CLI's) keeps it, and naming another once it
    is loaded raises."""
    from ics_tpu_torch.runtime import _lib

    if _lib.compiler() is None:
        pytest.skip("no C++ compiler to build the runtime with")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", _CACHE_CHILD, str(tmp_path / "builds"),
                           str(tmp_path / "other")], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "took" in proc.stdout
    assert any((tmp_path / "builds").glob("runtime-*/libics_runtime.so"))
    assert not (tmp_path / "other").exists()


@pytest.mark.parametrize("module,name", [("utils.selftest", "bench_conv_backends"),
                                         ("utils.resize", "resize_jax")])
def test_signature_starts_with_jaxs(module, name):
    """The port's function takes JAX's parameters first, in JAX's order and
    with JAX's defaults; the port's own extras come after, as keywords."""
    jax_fn = getattr(importlib.import_module(f"ics_tpu.{module}"), name)
    port_fn = getattr(importlib.import_module(f"ics_tpu_torch.{module}"), name)
    want = list(inspect.signature(jax_fn).parameters.values())
    got = list(inspect.signature(port_fn).parameters.values())
    assert [(p.name, p.default) for p in got[: len(want)]] == \
        [(p.name, p.default) for p in want]
    assert all(p.kind == p.KEYWORD_ONLY for p in got[len(want):])
