"""The solvers' device-state outer loop (models/rl_mm.py::_state_loop with
K7's twin, ops/cuda_outer.py) against the JAX solvers' ``lax.while_loop``
(and ``tv_denoise``'s ``lax.fori_loop``) on the CPU: the MM solver, PAM, PD
and ``tv_denoise``.  On the CPU every one-image solve takes the host loop,
inside ``_eager_outer_loop()`` and under the profiler too; the fold's loop
is held against it in tests/test_torch_parallel.py."""

import numpy as np
import pytest
import torch

from ics_tpu.models import rl_mm as jrl
from ics_tpu.models import rl_pam as jpam
from ics_tpu.models import rl_pd as jpd
from ics_tpu.models.tv_denoise import tv_denoise as j_tv_denoise
from ics_tpu.ops.reductions import whiteness_weights

from ics_tpu_torch.models import rl_mm as trl
from ics_tpu_torch.models import rl_pam as tpam
from ics_tpu_torch.models import rl_pd as tpd
from ics_tpu_torch.models.tv_denoise import tv_denoise
from ics_tpu_torch.ops import cuda_conv, cuda_outer, cuda_solver
from test_torch_solver import IMAGE, PSF, U, WIN, _args

CASES = {
    "blind, stop on": dict(tau=0.0, iterations=40, blind=True),
    "non-blind, stop on": dict(tau=1e-4, iterations=40, blind=False),
    "iterations cap": dict(tau=1e9, iterations=5, blind=False),
    "non-blind plateau stop": dict(tau=1e9, iterations=30, blind=False,
                                   cfg=dict(early_stop=1e-3, early_stop_patience=2)),
    "record_metrics": dict(tau=1e9, iterations=5, blind=True, cfg=dict(record_metrics=True)),
}


def _pair(kw):
    kw = dict(kw)
    cfg = kw.pop("cfg", {})
    args, kw = _args(lambd=1000.0, **kw)
    want = jrl.richardson_lucy_MM(*args, config=jrl.RLConfig(**cfg), **kw)
    got = trl.richardson_lucy_MM(*args, config=trl.RLConfig(**cfg), device="cpu", **kw)
    return want, got


@pytest.mark.parametrize("case", list(CASES))
def test_device_state_loop_matches_jax_and_the_python_loop(case):
    want, got = _pair(CASES[case])
    route = trl.loop_log[-1]
    assert (route["route"], route["outers"], route["reads"]) == ("host", got.iterations,
                                                                 got.iterations)
    assert (got.iterations, got.converged) == (want.iterations, want.converged)
    if case == "non-blind plateau stop":
        assert got.iterations < 30 and got.converged  # the plateau fired, not tau
    if case == "iterations cap":
        assert (got.iterations, got.converged) == (5, False)
    # u: a few outers of five inner steps in another f32 summation order;
    # M_r, Hu and varu: reductions in another order
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.stats.numpy(), np.asarray(want.stats), atol=1e-6, rtol=0)
    if got.trajectory is not None:
        for key in ("M_r", "Hu", "varu"):
            assert len(got.trajectory[key]) == got.iterations
            np.testing.assert_allclose(got.trajectory[key], want.trajectory[key], atol=1e-6,
                                       rtol=0, err_msg=key)


def test_use_stopping_false_matches_jax():
    kw = dict(**WIN, tau=0.0, step_factor=1e-3, lambd=1000.0, iterations=4, blind=True,
              correlation=False, use_stopping=False, record=True)
    w = whiteness_weights(WIN["bottom"] - WIN["top"], WIN["right"] - WIN["left"])
    want = jrl._solve(*map(np.asarray, (IMAGE, U, PSF, w)), use_tv=False, **kw)
    got = trl._solve(*map(torch.from_numpy, (IMAGE, U, PSF)), w, **kw)
    assert trl.loop_log[-1]["outers"] == 4
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), atol=1e-6, rtol=0)
    assert got[4][:2].tolist() == [4.0, 0.0]
    for key in ("M_r", "Hu", "varu"):
        np.testing.assert_allclose(got[5][key].numpy(), np.asarray(want[5][key]), atol=1e-6,
                                   rtol=0)
    assert not got[5]["M_r"].any()  # no metric without the stop, as JAX


def _np_stop(seq, *, iterations, blind, tau, early_stop=0.0, patience=10, use_stopping=True):
    """ics_tpu/models/rl_mm.py:543-575 and outer_cond :598-600 in numpy
    float32, one M_r of ``seq`` per outer."""
    f = np.float32
    m_r, m_r_prev, m_r_best, since, it, stop = f(0), f(0), f(np.inf), 0, 0, False
    while it < iterations and not stop:
        if use_stopping:
            m_r_new = f(seq[it])
            m_r_prev_new = m_r if it > 0 else m_r_prev
            if blind:
                hit = m_r_new > m_r_prev_new
            else:
                hit = (m_r_new - m_r_prev_new) / (m_r_new + m_r_prev_new) > f(tau)
            stop = bool(it > 1 and hit)
            if early_stop > 0.0 and not blind:
                improved = m_r_new < m_r_best * f(1.0 - early_stop)
                m_r_best = m_r_new if improved else m_r_best
                since = 0 if improved else since + 1
                stop = stop or (it > 1 and since >= patience)
            m_r, m_r_prev = m_r_new, m_r_prev_new
        it += 1
    return it, since, stop, [m_r, m_r_prev, m_r_best]


SEQS = {
    "falling then rising, blind": ([5.0, 4.0, 3.0, 2.5, 2.6, 1.0], dict(blind=True, tau=0.0)),
    "rising at once, blind": ([1.0, 2.0, 3.0, 4.0], dict(blind=True, tau=0.0)),
    "falling, blind, cap": ([9.0, 8.0, 7.0, 6.0, 5.0], dict(blind=True, tau=0.0)),
    # a rise of 2.6e-5 relative goes on, one of 1.7e-4 stops
    "non-blind, tau": ([3.0, 2.0, 1.9, 1.9001, 1.8, 1.8006, 1.0], dict(blind=False, tau=1e-4)),
    "non-blind, tau 0": ([3.0, 2.0, 1.5, 1.6, 1.0], dict(blind=False, tau=0.0)),
    "non-blind, tau 1e9, cap": ([3.0, 4.0, 5.0, 6.0, 7.0], dict(blind=False, tau=1e9)),
    "plateau stop": ([1.0, 0.9995, 0.999, 0.9988, 0.9987, 0.9986, 0.5],
                     dict(blind=False, tau=1e9, early_stop=1e-3, patience=2)),
    "slow decrease outruns the plateau": ([1.0 - 6e-4 * i for i in range(7)],
                                          dict(blind=False, tau=1e9, early_stop=1e-3,
                                               patience=2)),
    "blind ignores the plateau": ([1.0, 1.0, 1.0, 1.0, 1.0],
                                  dict(blind=True, tau=0.0, early_stop=1e-3, patience=1)),
    "use_stopping=False": ([1.0, 2.0, 3.0, 4.0], dict(blind=True, tau=0.0,
                                                      use_stopping=False)),
    "NaN metric never stops": ([1.0, float("nan"), float("nan"), float("nan")],
                               dict(blind=False, tau=0.0)),
    "one outer": ([1.0, 2.0], dict(blind=True, tau=0.0, iterations=1)),
}


@pytest.mark.parametrize("name", list(SEQS))
def test_outer_stop_plain_matches_the_jax_transcription(name):
    seq, kw = SEQS[name]
    kw = {"iterations": len(seq) - 1, **kw}
    want = _np_stop(seq, **kw)
    mr, ints, go = cuda_outer.initial_state("cpu", kw["iterations"])
    while bool(go):
        m_r_new = torch.tensor(seq[int(ints[0])], dtype=torch.float32)
        before = cuda_outer.launches
        cuda_outer.outer_stop(m_r_new if kw.get("use_stopping", True) else mr[0], mr, ints,
                              go, **kw)
        assert cuda_outer.launches == before  # the twin counts no launch
    it, since, stop, more = ints.tolist()
    assert (it, since, bool(stop), more) == (want[0], want[1], want[2], 0)
    np.testing.assert_array_equal(mr.numpy(), np.array(want[3], dtype=np.float32))


def test_replays_count_the_change_of_one_body_times_the_outers_run():
    before = trl._read_launches()
    try:
        # a capture of one body: the wrappers count its launches once...
        cuda_conv.launches += 10
        cuda_solver.launches += 1
        cuda_outer.launches += 1
        per_body = [a - b for a, b in zip(trl._read_launches(), before)]
        trl._write_launches(before)  # ...but a capture launches nothing
        assert trl._read_launches() == before
        trl._count_replays(per_body, 3)
        trl._count_replays(per_body, 1)
        after = trl._read_launches()
        assert cuda_conv.launches == before[0] + 40
        assert cuda_solver.launches == before[1] + 4
        assert cuda_outer.launches == before[5] + 4
        assert sum(after) - sum(before) == 4 * 12
    finally:
        trl._write_launches(before)


def _while_entry(outers, reads):
    return dict(route="while", outers=outers, reads=reads, k7w=None, capture_ms=1.0,
                instantiate_ms=1.0)


@pytest.mark.parametrize("outers,k7w", [(6, 6), (6, 5), (6, 7)])
def test_settle_counts_a_while_launch_from_k7w_own_count(outers, k7w):
    """A WHILE launch is counted from the state read back: K7's ``it`` and
    K7w's runs must agree, one of each per outer; the wrapper counters add
    one captured body's launches times the bodies K7w counted."""
    before = trl._read_launches()
    per_body = [0] * len(before)
    per_body[0], per_body[5] = 3, 1  # K1 three times and K7 once per body
    entry = _while_entry(outers, 1)
    try:
        if k7w != outers:
            with pytest.raises(RuntimeError, match="K7w runs"):
                trl._settle(entry, per_body, [outers, 0, 1, 0, k7w])
            assert trl._read_launches() == before
            return
        trl._settle(entry, per_body, [outers, 0, 1, 0, k7w])
        after = trl._read_launches()
        assert (entry["outers"], entry["k7w"]) == (outers, k7w)
        assert after[0] - before[0] == 3 * (k7w - 1)
        assert after[5] - before[5] == k7w - 1
        assert cuda_outer.while_launches - before[-1] == k7w
    finally:
        trl._write_launches(before)


class _Copy:
    """A stand-in for the CUDA event after a launch's copy of its counts."""

    def __init__(self, done):
        self.done, self.waited = done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = True


@pytest.mark.parametrize("runs", [7, 6])
def test_a_fixed_count_while_launch_is_counted_when_the_counters_are_read(runs):
    """A fixed-count loop (``tv_denoise``) reads nothing: its launch waits in
    ``_UNREAD`` until its copy of the counts is done and a solve starts, or
    until the counters are read, which waits for the copy; K7w's count is
    held against the count the loop was given (7)."""
    before = trl._read_launches()
    per_body = [0] * len(before)
    per_body[5] = 1
    entry = _while_entry(7, 0)
    counts = torch.tensor([runs, 0, 0, 0, runs], dtype=torch.int32)
    copied = _Copy(done=False)
    try:
        trl._UNREAD.append((entry, per_body, counts, copied))
        trl._settle_unread(wait=False)  # a solve's start: the copy is not done
        assert trl._launch_values() == before and entry["k7w"] is None and trl._UNREAD
        if runs != 7:
            with pytest.raises(RuntimeError, match="per outer, 7 outers"):
                trl._read_launches()
        else:
            after = trl._read_launches()
            assert entry["k7w"] == 7 and after[-1] - before[-1] == 7
            assert after[5] - before[5] == 6
        assert not trl._UNREAD and copied.waited
    finally:
        trl._UNREAD.clear()
        trl._write_launches(before)


def test_eager_outer_loop_restores_the_route_on_exit():
    args, kw = _args(tau=1e9, iterations=2, lambd=1000.0, blind=False)
    assert trl._EAGER_LOOP is False
    trl.loop_log.clear()
    host = dict(route="host", outers=2, reads=2, k7w=None, capture_ms=None, instantiate_ms=None)
    with trl._eager_outer_loop():
        assert trl._EAGER_LOOP is True
        trl.richardson_lucy_MM(*args, device="cpu", **kw)
        with trl._eager_outer_loop():  # nested: the outer block stays eager
            pass
        assert trl._EAGER_LOOP is True
    assert trl._EAGER_LOOP is False
    assert list(trl.loop_log) == [host]  # the eager block's solve: the host loop
    with pytest.raises(RuntimeError, match="inside"), trl._eager_outer_loop():
        raise RuntimeError("inside")
    assert trl._EAGER_LOOP is False
    trl.richardson_lucy_MM(*args, device="cpu", **kw)
    assert list(trl.loop_log) == [host, host]


SOLVERS = {"pam": (jpam.richardson_lucy_PAM, tpam.richardson_lucy_PAM),
           "pd": (jpd.richardson_lucy_PD, tpd.richardson_lucy_PD)}
SOLVER_CASES = {
    "blind, stop on": dict(tau=0.0, iterations=40, blind=True),
    "non-blind, stop on": dict(tau=1e-4, iterations=40, blind=False),
    "iterations cap": dict(tau=1e9, iterations=5, blind=False),
}


@pytest.mark.parametrize("case", list(SOLVER_CASES))
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_pam_pd_device_state_loop_matches_jax_and_the_python_loop(solver, case):
    """PAM and PD through ``_solve_outers``' device-state loop: JAX's outer
    count and verdict, u within 5e-5 (five inner steps per outer in another
    f32 order), the PSF within 1e-6, the stats within 1e-6 or 1e-4 relative
    (M_r, a reduction in another order: PD's reads 1.9e-5 relative after 5
    outers); one host read per outer."""
    kw = dict(SOLVER_CASES[case])
    args = (IMAGE, U, PSF, *WIN.values(), kw.pop("tau"))
    jfn, tfn = SOLVERS[solver]
    want = jfn(*args, **kw)
    trl.loop_log.clear()
    got = tfn(*args, device="cpu", **kw)
    log = trl.loop_log[-1]
    assert len(trl.loop_log) == 1
    assert (log["route"], log["outers"], log["reads"]) == ("host", got.iterations,
                                                         got.iterations)
    assert (got.iterations, got.converged) == (want.iterations, want.converged)
    if case == "iterations cap":
        assert (got.iterations, got.converged) == (5, False)
    else:
        assert got.converged and got.iterations < 40
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=5e-5, rtol=0)
    np.testing.assert_allclose(got.psf.numpy(), np.asarray(want.psf), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.stats.numpy(), np.asarray(want.stats), atol=1e-6, rtol=1e-4)


def _planar_np(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(2, 0, 1).contiguous()


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_pam_pd_use_stopping_false_matches_jax(solver):
    """``use_stopping=False``: K7 only counts to ``iterations``, M_r stays 0,
    as JAX's."""
    w = whiteness_weights(WIN["bottom"] - WIN["top"], WIN["right"] - WIN["left"])
    if solver == "pam":
        kw = dict(**WIN, tau=0.0, step_factor=1e-3, lambda_tv=2e-3, epsilon=1e-3,
                  iterations=4, blind=True, correlation=False, use_stopping=False)
        want = jpam._solve_pam(*map(np.asarray, (IMAGE, U, PSF, w)), conv_method="auto", **kw)
        run = lambda: tpam._solve_pam(*map(torch.from_numpy, (IMAGE, U, PSF)), w, **kw)
        hwc = lambda t: t
    else:
        kw = dict(**WIN, tau_stop=0.0, step_factor=1e-3, lambda_tv=1e-4, sigma=0.05, tau=0.05,
                  theta=1.0, iterations=4, blind=True, correlation=False, use_stopping=False)
        want = jpd._solve_pd(*map(np.asarray, (IMAGE, IMAGE, PSF, w)), **kw)
        run = lambda: tpd._solve_pd(_planar_np(IMAGE), _planar_np(IMAGE), _planar_np(PSF), w,
                                    **kw)
        hwc = lambda t: t.permute(1, 2, 0)
    got = run()
    assert trl.loop_log[-1]["outers"] == 4
    np.testing.assert_allclose(hwc(got[0]).numpy(), np.asarray(want[0]), atol=5e-5, rtol=0)
    np.testing.assert_allclose(hwc(got[1]).numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
    want_stats = np.array([float(want[2]), float(want[3]), *map(float, want[4:])])
    np.testing.assert_allclose(got[2].numpy(), want_stats, atol=1e-6, rtol=0)
    assert got[2][:3].tolist() == [4.0, 0.0, 0.0]


@pytest.mark.parametrize("shape,iterations", [((23, 31, 3), 20), ((40, 27), 7), ((9, 12, 3), 1),
                                              ((9, 12, 3), 0)])
def test_tv_denoise_device_state_loop_matches_jax_and_the_eager_loop(shape, iterations):
    """``tv_denoise``'s iterations through the device-state loop, K7 as the
    counter: within 1e-6 of JAX's ``fori_loop`` (elementwise float32 in
    another fusion), one outer per iteration."""
    image = np.random.default_rng(sum(shape) + iterations).random(shape).astype(np.float32)
    want = np.asarray(j_tv_denoise(image, weight=0.1, iterations=iterations))
    trl.loop_log.clear()
    before = cuda_outer.launches
    got = tv_denoise(image, weight=0.1, iterations=iterations, device="cpu")
    assert cuda_outer.launches == before  # the twin counts no launch
    assert trl.loop_log[-1] == dict(route="host", outers=iterations, reads=iterations,
                                    k7w=None, capture_ms=None, instantiate_ms=None)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("solver", ["mm", "pam", "pd", "tv_denoise"])
def test_a_solve_under_the_profiler_takes_the_python_loop(solver):
    """While torch's profiler runs, every solve takes the host loop
    (``_eager_loop``; no WHILE launch runs under a profiler, fault E): one
    logged 'host' solve, one read per outer, with the unprofiled solve's
    bits."""
    from torch.profiler import ProfilerActivity, profile

    if solver == "tv_denoise":
        image = np.random.default_rng(3).random((23, 31, 3)).astype(np.float32)
        run = lambda: (tv_denoise(image, weight=0.1, iterations=6, device="cpu"),)
    else:
        fn = {"mm": trl.richardson_lucy_MM, "pam": tpam.richardson_lucy_PAM,
              "pd": tpd.richardson_lucy_PD}[solver]
        args = (IMAGE, U, PSF, *WIN.values(), 0.0)
        run = lambda: (lambda r: (r.u, r.psf, r.stats))(
            fn(*args, iterations=6, blind=True, device="cpu"))
    want = run()
    outers = trl.loop_log[-1]["outers"]
    trl.loop_log.clear()
    assert not trl._eager_loop()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trl._eager_loop()
        got = run()
    assert not trl._eager_loop()
    assert [(e["route"], e["outers"], e["reads"]) for e in trl.loop_log] == [("host", outers,
                                                                            outers)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_a_done_copy_is_counted_at_the_next_solve_start():
    """A solve's start counts the fixed-count launches whose copy of the
    counts is done, without waiting for any."""
    before = trl._read_launches()
    entry = _while_entry(3, 0)
    copied = _Copy(done=True)
    try:
        trl._UNREAD.append((entry, [0] * len(before), torch.tensor([3, 0, 0, 0, 3]), copied))
        trl._settle_unread(wait=False)
        assert entry["k7w"] == 3 and not trl._UNREAD
        assert trl._launch_values()[-1] - before[-1] == 3
    finally:
        trl._UNREAD.clear()
        trl._write_launches(before)
