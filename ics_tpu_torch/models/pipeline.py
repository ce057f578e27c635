"""End-to-end blind-deconvolution pipeline (counterpart of
ics_tpu/models/pipeline.py; parity target: reference deconvolve.py:24-368).

Normalize by bit depth, remove gamma, pad to odd dimensions, build the √2
coarse-to-fine pyramid, run a blind pass (PSF estimation on a mask window)
then a non-blind pass (full frame), then clip, re-gamma and convert to
16 bits.  The host drives the pyramid; every image stays on ``device``
between levels, and only solver status scalars come back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ics_tpu_torch._device import exact_f32, resolve_device, synchronize
from ics_tpu_torch.models.checkpoint import (
    SolverCheckpoint,
    load_checkpoint,
    save_checkpoint,
)
from ics_tpu_torch.models.rl_mm import RLConfig, richardson_lucy_MM
from ics_tpu_torch.models.rl_pam import richardson_lucy_PAM
from ics_tpu_torch.models.rl_pd import richardson_lucy_PD
from ics_tpu_torch.ops.psf import normalize_kernel
from ics_tpu_torch.ops.windows import uniform_kernel
from ics_tpu_torch.parallel.tiling import sharded_richardson_lucy
from ics_tpu_torch.utils.io import save
from ics_tpu_torch.utils.resize import resize as resize_scipy
from ics_tpu_torch.utils.resize import resize_jax
from ics_tpu_torch.utils.timing import timeit
from ics_tpu_torch.utils.trace import Tracer

__all__ = ["pad_image", "build_pyramid", "deblur_module"]

# precision='hybrid'/'hybrid-high': smallest coarse non-blind level that
# runs the reduced-precision config (ics_tpu/models/pipeline.py:38)
_HYBRID_MIN_PIXELS = 2_000_000

# the solver's step factor for each --quality (deblur and deblur-batch)
QUALITY_STEP = {"normal": 1e-3, "high": 5e-4, "veryhigh": 1e-4, "low": 5e-3}


def _upload(raw: np.ndarray, device: torch.device) -> torch.Tensor:
    """Raw frame to ``device`` as float32, moving the integer bytes only."""
    raw = np.ascontiguousarray(raw)
    if raw.dtype == np.uint8:
        return torch.from_numpy(raw).to(device).to(torch.float32)
    if raw.dtype == np.uint16:
        # torch has no general uint16 arithmetic: move the bits as int16
        bits = torch.from_numpy(raw.view(np.int16)).to(device)
        return torch.bitwise_and(bits.to(torch.int32), 0xFFFF).to(torch.float32)
    return torch.from_numpy(raw.astype(np.float32)).to(device)


def _pad_edge(arr: torch.Tensor, rows, cols) -> torch.Tensor:
    """Edge-replicate padding of an (H, W, C) tensor; always a new tensor."""
    x = arr.permute(2, 0, 1).unsqueeze(0)
    x = F.pad(x, (cols[0], cols[1], rows[0], rows[1]), mode="replicate")
    return x[0].permute(1, 2, 0).contiguous()


def _preprocess(raw: np.ndarray, samples: int, device: torch.device) -> torch.Tensor:
    """Integer frame -> padded, normalized, de-gamma'd float32 (ref
    deconvolve.py:94-103)."""
    pic = _pad_edge(_upload(raw, device), (1, 1), (1, 1))
    return torch.pow(pic / samples, 1 / 2.2)


def _postprocess(img: torch.Tensor):
    """clip -> re-gamma -> 16 bits (ref deconvolve.py:346-352), plus the NaN
    flag, checked BEFORE the integer cast, which would map NaN to an
    arbitrary integer.  The cast goes through int32 on the device; the host
    finishes the uint16."""
    clipped = torch.clamp(img, 0.0, 1.0) ** 2.2
    return (clipped * (2**16 - 1)).to(torch.int32), torch.isnan(clipped).any()


def pad_image(image: np.ndarray, pad, mode: str = "edge") -> np.ndarray:
    """Pad a 3-channel image with a free boundary condition (ref deconvolve.py:24-37)."""
    channels = [np.pad(image[..., c], pad, mode=mode) for c in range(3)]
    return np.ascontiguousarray(np.dstack(channels), np.float32)


def build_pyramid(psf_size: int, lambd: float = 10.0):
    """Coarse-to-fine schedule: image scales shrink by √2 per level, kernel
    sizes ceil(k/√2) forced odd and >= 3 (ref deconvolve.py:40-60).

    Copied from ics_tpu/models/pipeline.py:74-86 (host-side NumPy)."""
    images = [1.0]
    kernels = [psf_size]
    while kernels[-1] > 3:
        kernels.append(int(np.ceil(kernels[-1] / np.sqrt(2))))
        images.append(images[-1] / np.sqrt(2))
        if kernels[-1] % 2 == 0:
            kernels[-1] -= 1
        if kernels[-1] < 3:
            kernels[-1] = 3
    return images, kernels


def _write_back(deblured_image, res, temp_top, temp_bottom, temp_left,
                temp_right, pad):
    """Write a mask-window solve back into the full frame, in place.

    The reference solver mutates the caller's array through a view, so the
    whole padded window, halo ring included, is written back (ref
    deconvolve.py:277-288) by the solvers that return ``u_full`` (MM); the
    others (PAM, PD) write their inner box, as ics_tpu/models/pipeline.py:
    89-107 falls back."""
    if res.u_full is not None:
        deblured_image[
            temp_top - pad - 1 : temp_bottom + pad + 1,
            temp_left - pad - 1 : temp_right + pad + 1,
        ] = res.u_full
    else:
        deblured_image[temp_top - 1 : temp_bottom + 1, temp_left - 1 : temp_right + 1] = res.u
    return deblured_image


@timeit
def deblur_module(
    pic,
    filename: str,
    dest_path: str | None,
    blur_width: int,
    confidence: float = 10,
    tolerance: float = 1,
    quality: str = "normal",
    bits: int = 8,
    mask=None,
    display: bool = False,
    blur: str = "static",
    preview: bool = False,
    p: float = 1,
    order: int = 2,
    norm: int = 1,
    priority: float = 0,
    mask_size: int = 255,
    iterations: int = 200,
    refocus: bool = False,
    config: RLConfig | None = None,
    verbose: bool = True,
    trace=False,
    resize_backend: str = "jax",
    solver: str = "mm",
    psf_path: str | None = None,
    save_psf_path: str | None = None,
    precision: str = "exact",
    early_stop: float = 0.0,
    blind_budget: int | None = None,
    use_tv: bool = False,
    tv_norm: str = "channel",
    inner_loop: str = "auto",
    stats_out: list | None = None,
    compute_timer: dict | None = None,
    nonblind_levels: str = "all",
    mesh=None,
    shard_axis: str = "tile",
    device="cuda",
) -> np.ndarray:
    """Blind deblurring API, with the kwargs of ``ics_tpu.deblur_module``
    (parity: ref deconvolve.py:66-368).  Returns the 16-bit image array.

    Ported: the ``mm`` solver, blind then non-blind, in every ``precision``
    ('exact', 'high', 'mixed', 'fast', 'hybrid', 'hybrid-high'), with
    ``use_tv`` / ``tv_norm``, ``inner_loop``, ``preview``, ``blind_budget``,
    ``nonblind_levels``, ``early_stop``, ``psf_path`` / ``save_psf_path``,
    ``display`` (matplotlib, imported only then: after the blind phase,
    the PSF scaled to [0, 1], then the mask window as uint8),
    ``stats_out``, ``compute_timer``, ``trace``, ``resize_backend`` ('jax',
    the on-device cubic, or 'scipy', the host spline) and ``dest_path``
    (a 16-bit TIFF ``<filename>.tif``, ``-preview`` appended with
    ``preview``).  ``solver`` 'pam' (TV-PAM) and 'pd' (TV-PD) run the same
    pyramid, routed as ics_tpu/models/pipeline.py:412-421 routes them:
    ``config`` passes through as their ``PAMConfig`` / ``PDConfig``;
    ``precision``, ``use_tv``, ``tv_norm``, ``inner_loop``, ``early_stop``
    and ``verbose``'s solver report are the 'mm' solver's only.

    ``mesh``: a 1-D ``DeviceMesh`` (``parallel.make_mesh``) whose dimension
    is named ``shard_axis``; every rank calls ``deblur_module`` with the
    same arguments.  The full-frame non-blind levels split their rows over
    the ranks (``parallel.sharded_richardson_lucy``); the blind mask-window
    levels run whole on every rank.  Every rank returns the same array;
    only rank 0 writes ``dest_path`` and ``save_psf_path``.  The 'mm'
    solver only.

    ``device``: 'cuda' (the default; raises without a GPU) or 'cpu'.
    ``compute_timer`` times upload-complete to result-ready on the device,
    synchronizing the device at both ends.  ``trace``: True prints a
    per-stage profile; or pass a ``utils.trace.Tracer``.  ``Tracer()``
    (``sync=True``) accumulates each stage's seconds and synchronizes the
    device at both ends of every stage; ``Tracer(sync=False)`` synchronizes
    nothing: it records a span per stage, and within the frame
    (``Tracer.frame``) each WHILE solve's spans, with the card's stamps on
    the current stream, for ``Tracer.collect()`` to read after this call
    returns.  Every statement that launches device work lies inside a
    stage.
    """
    dev = resolve_device(device)
    exact_f32()
    tracer = trace if isinstance(trace, Tracer) else (Tracer() if trace else None)

    def _stage(name):
        return tracer.stage(name) if tracer is not None else contextlib.nullcontext()

    if mesh is not None:
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch DeviceMesh, got {type(mesh).__name__}")
        if tuple(mesh.mesh_dim_names or ()) != (shard_axis,):
            raise ValueError(
                f"mesh must be 1-D with its dimension named {shard_axis!r}, got "
                f"{mesh.mesh_dim_names}"
            )
        if mesh.device_type != dev.type:
            raise ValueError(f"a {mesh.device_type} mesh for device {str(dev)!r}")
    writes = mesh is None or dist.get_rank() == 0

    if resize_backend == "jax":
        resize = resize_jax
    else:  # the host spline, as ics_tpu/models/pipeline.py:247-252 does
        resize = lambda a, s: torch.from_numpy(
            resize_scipy(a.cpu().numpy(), s).astype(np.float32)
        ).to(dev)

    with tracer.frame(dev) if tracer is not None else contextlib.nullcontext():
        with _stage("upload + preprocess"):
            samples = 2**bits - 1
            pic = _preprocess(np.asarray(pic), samples, dev)

        if compute_timer is not None:
            synchronize(dev)
            compute_timer["_t0"] = time.perf_counter()

        step = QUALITY_STEP[quality]

        loaded_psf = None
        if psf_path is not None and save_psf_path is not None:
            # with a loaded PSF the blind phase (the only producer of a new
            # estimate) is skipped, so the save would silently never happen
            raise ValueError(
                "psf_path and save_psf_path are mutually exclusive: loading a "
                "PSF skips the blind phase, so there is no new estimate to save"
            )
        if psf_path is not None:
            loaded_psf = np.asarray(load_checkpoint(psf_path).psf, np.float32)
            if (
                loaded_psf.ndim != 3
                or loaded_psf.shape[0] != loaded_psf.shape[1]
                or loaded_psf.shape[2] != 3
            ):
                raise ValueError(
                    f"stored PSF has shape {loaded_psf.shape}; expected (k, k, 3)"
                )
            blur_width = int(loaded_psf.shape[0])

        if blur_width < 3:
            raise ValueError("The blur width should be at least 3 pixels.")
        elif blur_width % 2 == 0:
            raise ValueError(
                "The blur width should be odd. You can use %i." % (blur_width + 1)
            )
        if solver not in ("mm", "pam", "pd"):
            raise ValueError(f"unknown solver {solver!r} (use 'mm', 'pam' or 'pd')")
        if nonblind_levels not in ("all", "final"):
            raise ValueError("nonblind_levels must be 'all' or 'final'")
        if blind_budget is not None and blind_budget < 1:
            raise ValueError("blind_budget must be a positive iteration count")
        if mesh is not None and solver != "mm":
            raise ValueError("mesh sharding is only supported by the 'mm' solver")

        M, N = pic.shape[0], pic.shape[1]

        if mask is None:
            mask = [M // 2, N // 2]
        top = mask[0] - mask_size // 2
        bottom = mask[0] + mask_size // 2
        left = mask[1] - mask_size // 2
        right = mask[1] + mask_size // 2
        if verbose:
            print("Mask size :", (bottom - top + 1), "×", (right - left + 1))
        if not (top > 0 and bottom < M and left > 0 and right < N):
            raise ValueError(
                "The mask is outside the picture boundaries. Move its center "
                "inside or reduce the blur size."
            )

        correlation = blur == "motion"  # ref :154-157
        tolerance = tolerance / 100.0

        with _stage("pad + psf upload"):
            # Odd-dimension padding (ref :163-175)
            odd_vert = odd_hor = False
            if pic.shape[0] % 2 == 0:
                pic = _pad_edge(pic, (1, 0), (0, 0))
                odd_vert = True
            if pic.shape[1] % 2 == 0:
                pic = _pad_edge(pic, (0, 0), (1, 0))
                odd_hor = True

            if loaded_psf is not None:
                psf = torch.from_numpy(loaded_psf).to(dev)
            else:
                psf = torch.from_numpy(
                    np.dstack([uniform_kernel(blur_width)] * 3).astype(np.float32)
                ).to(dev)

        images, kernels = build_pyramid(blur_width, confidence)

        if precision not in ("exact", "high", "mixed", "fast", "hybrid",
                             "hybrid-high"):
            raise ValueError(
                f"unknown precision {precision!r} (use 'exact', 'high', "
                "'mixed', 'fast', 'hybrid' or 'hybrid-high')"
            )
        solver_cfg_coarse = None
        if solver == "mm":
            # precision -> solver dtype, conv precision and guard
            # (ics_tpu/models/pipeline.py:357-411): 'high' forces the DoF guard
            # on every solve, blind ones included, as the JAX package does
            solver_cfg = config or RLConfig(
                p=p, norm=norm, order=order, priority=priority, refocus=refocus,
                dtype={"mixed": "mixed", "fast": "bfloat16"}.get(precision, "float32"),
                early_stop=early_stop,
                conv_precision="high" if precision == "high" else "exact",
                use_tv=use_tv, tv_norm=tv_norm, inner_loop=inner_loop,
                dof_guard=True if precision == "high" else None,
            )
            # 'hybrid' / 'hybrid-high': the coarse non-blind levels of at least
            # _HYBRID_MIN_PIXELS run mixed, or f32 with K4s convs and the guard
            if config is None and precision in ("hybrid", "hybrid-high"):
                solver_cfg_coarse = dataclasses.replace(
                    solver_cfg,
                    **({"dtype": "mixed"} if precision == "hybrid"
                       else {"conv_precision": "high", "dof_guard": True}),
                )
            solve = lambda *a, cfg=solver_cfg, **kw: richardson_lucy_MM(
                *a, config=cfg, verbose=verbose, device=dev, **kw
            )
            if mesh is not None:  # the full-frame levels, rows over the ranks
                full_solve = lambda *a, cfg=solver_cfg, **kw: sharded_richardson_lucy(
                    *a, mesh=mesh, axis=shard_axis, config=cfg, verbose=verbose, **kw
                )
        else:
            # 'pam' / 'pd': ``config`` is their PAMConfig / PDConfig (None for
            # the defaults), the same on every level
            solver_cfg = config
            solve = lambda *a, cfg=solver_cfg, **kw: (
                richardson_lucy_PAM if solver == "pam" else richardson_lucy_PD
            )(*a, config=cfg, device=dev, **kw)

        deblured_image = pic
        cases = ["non-blind"] if loaded_psf is not None else ["blind", "non-blind"]

        try:
            for case in cases:
                if verbose:
                    print("\n===== %s DECONVOLUTION =====" % case)
                deblured_image = pic
                lambd = confidence * 1000  # ref :200

                for i, k in zip(reversed(images), reversed(kernels)):
                    if case == "non-blind" and nonblind_levels == "final" and i != 1.0:
                        continue
                    if verbose:
                        print("======== Pyramid step %1.3f ========" % i)

                    # Rescale the mask box; force odd/square-ish.  The branch
                    # structure (including the inert `>` comparison of a value
                    # with itself and the `-= -1`) replicates ref :209-230.
                    temp_top = int(i * top)
                    temp_bottom = int(i * bottom)
                    temp_left = int(i * left)
                    temp_right = int(i * right)
                    if (temp_bottom - temp_top) % 2 == 0:
                        if (temp_bottom - temp_top) < (temp_right - temp_left):
                            temp_bottom += 1
                        elif (temp_bottom - temp_top) > (temp_right - temp_left):
                            temp_top += 1
                        else:
                            temp_top -= 1
                    if (temp_right - temp_left) % 2 == 0:
                        if (temp_bottom - temp_top) < (temp_right - temp_left):
                            temp_left += 1
                        elif (temp_bottom - temp_top) > (temp_bottom - temp_top):
                            temp_right += 1
                        else:
                            temp_right += 1

                    temp_width = int(np.floor(i * N))
                    temp_height = int(np.floor(i * M))
                    if temp_width % 2 == 0:
                        temp_width += 1
                    if temp_height % 2 == 0:
                        temp_height += 1
                    shape = (temp_height, temp_width, 3)

                    with _stage("resize + pad"):
                        temp_blurry_image = resize(pic, shape)
                        deblured_image = resize(deblured_image, shape)
                        if case == "blind":
                            psf_copy = normalize_kernel(resize(psf, (k, k)))
                        else:
                            psf_copy = psf
                            k = kernels[0]

                        # Extra safety padding: the gradient is not evaluated on
                        # borders (ref :256-257)
                        temp_blurry_image = _pad_edge(temp_blurry_image, (1, 1), (1, 1))
                        deblured_image = _pad_edge(deblured_image, (1, 1), (1, 1))

                    pad = int(np.floor(k / 2))

                    if verbose:
                        print("Image size", tuple(temp_blurry_image.shape))
                        print("u size", tuple(deblured_image.shape))
                        print("Mask size", (temp_bottom - temp_top), (temp_right - temp_left))
                        print("PSF size", tuple(psf_copy.shape))

                    # No tolerance at lower pyramid scales (ref :268-273)
                    tolerance_temp = tolerance if i == 1.0 else 0
                    window = (
                        pad + 1, temp_bottom - temp_top - pad - 1,
                        pad + 1, temp_bottom - temp_top - pad - 1,
                    )

                    if case == "blind" or preview:
                        # blind_budget caps the coarse-level PSF refinement (its
                        # estimate only seeds the next level)
                        level_iterations = (
                            min(iterations, blind_budget)
                            if case == "blind" and blind_budget is not None and i != 1.0
                            else iterations
                        )
                        with _stage(f"solve ({case})"):
                            res = solve(
                                temp_blurry_image[
                                    temp_top - 1 : temp_bottom + 1,
                                    temp_left - 1 : temp_right + 1,
                                ],
                                deblured_image[
                                    temp_top - pad - 1 : temp_bottom + pad + 1,
                                    temp_left - pad - 1 : temp_right + pad + 1,
                                ],
                                psf_copy,
                                *window,
                                0 if case == "blind" else tolerance_temp,
                                iterations=level_iterations,
                                step_factor=step,
                                lambd=lambd,
                                blind=case == "blind",
                                correlation=correlation and case == "blind",
                            )
                            deblured_image = _write_back(
                                deblured_image, res, temp_top, temp_bottom,
                                temp_left, temp_right, pad,
                            )
                            if case == "blind":
                                psf = res.psf
                    else:
                        level_cfg = (
                            solver_cfg_coarse
                            if solver_cfg_coarse is not None and i != 1.0
                            and temp_height * temp_width >= _HYBRID_MIN_PIXELS
                            else solver_cfg
                        )
                        with _stage("pad (non-blind)"):
                            deblured_image = _pad_edge(deblured_image, (pad, pad), (pad, pad))
                        with _stage("solve (non-blind)"):
                            res = (solve if mesh is None else full_solve)(
                                temp_blurry_image,
                                deblured_image,
                                psf_copy,
                                *window,
                                tolerance_temp,
                                iterations=iterations,
                                step_factor=step,
                                lambd=lambd,
                                blind=False,
                                cfg=level_cfg,
                            )
                            deblured_image = res.u

                    if stats_out is not None:
                        stats_out.append({"case": case, "scale": i, "k": k, "result": res})

                    # Strip the safety padding (ref :322-323)
                    temp_blurry_image = temp_blurry_image[1:-1, 1:-1, ...]
                    deblured_image = deblured_image[1:-1, 1:-1, ...]

                if case == "blind" and save_psf_path is not None and writes:
                    # persist right after the blind phase, so the estimate
                    # survives an interrupted non-blind pass
                    with _stage("psf save"):
                        save_checkpoint(
                            save_psf_path,
                            SolverCheckpoint(
                                psf=psf.cpu().numpy(), blur_width=blur_width, phase="blind"
                            ),
                        )
                    if verbose:
                        print("Saved estimated PSF to %s" % save_psf_path)

                if display and case == "blind":  # control preview (ref :331-336)
                    import matplotlib.pyplot as plt

                    with _stage("display"):
                        psf_np = psf.cpu().numpy()
                        shown = (deblured_image[top:bottom, left:right, ...] * 255).cpu().numpy()
                    psf_check = (psf_np - np.amin(psf_np)) / (np.amax(psf_np) - np.amin(psf_np))
                    plt.imshow(psf_check, interpolation="lanczos", aspect="equal", vmin=0, vmax=1)
                    plt.show()
                    plt.imshow(
                        shown.astype(np.uint8),
                        interpolation="lanczos", aspect="equal", vmin=0, vmax=255,
                    )
                    plt.show()

        except KeyboardInterrupt:
            # Salvage the current iterate on hard interrupt (ref :338-342)
            pass

        with _stage("postprocess + download"):
            out_dev, nan_dev = _postprocess(deblured_image)
            has_nan = bool(nan_dev)  # one scalar read: the device queue drains
            if compute_timer is not None and "_t0" in compute_timer:
                compute_timer["compute_s"] = time.perf_counter() - compute_timer.pop("_t0")
            deblured_image = out_dev.cpu().numpy().astype(np.uint16)
        if has_nan:
            print(
                "WARNING: result contains NaN (solver diverged) — "
                "those pixels are undefined in the 16-bit output."
            )

        if preview:
            filename = filename + "-preview"
            deblured_image = deblured_image[top:bottom, left:right, ...]
        else:
            if odd_hor:
                deblured_image = deblured_image[:, 1:, ...]
            if odd_vert:
                deblured_image = deblured_image[1:, :, ...]
            deblured_image = deblured_image[1:-1, 1:-1, ...]

        if dest_path is not None and writes:
            with _stage("tiff save"):
                os.makedirs(dest_path, exist_ok=True)
                save(deblured_image, filename, dest_path)

    if tracer is not None and verbose and not isinstance(trace, Tracer):
        print("---- deblur_module stage profile (stages serialized) ----")
        print(tracer.report())

    return deblured_image
