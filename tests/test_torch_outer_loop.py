"""The RL-MM solver's device-state outer loop (models/rl_mm.py::_solve with
K7's twin, ops/cuda_outer.py) against the JAX solver's ``lax.while_loop`` on
the CPU, and against the port's Python outer loop bitwise."""

import numpy as np
import pytest
import torch

from ics_tpu.models import rl_mm as jrl
from ics_tpu.ops.reductions import whiteness_weights

from ics_tpu_torch.models import rl_mm as trl
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
    with trl._eager_outer_loop():
        eager = trl.richardson_lucy_MM(*args, config=trl.RLConfig(**cfg), device="cpu", **kw)
    return want, got, eager


@pytest.mark.parametrize("case", list(CASES))
def test_device_state_loop_matches_jax_and_the_python_loop(case):
    want, got, eager = _pair(CASES[case])
    route = trl.loop_log[-1]  # the device-state solve; the eager one logs nothing
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
    for name in ("u", "u_full", "psf", "image", "stats"):
        assert torch.equal(getattr(got, name), getattr(eager, name)), name
    if got.trajectory is not None:
        for key in ("M_r", "Hu", "varu"):
            assert len(got.trajectory[key]) == got.iterations
            np.testing.assert_allclose(got.trajectory[key], want.trajectory[key], atol=1e-6,
                                       rtol=0, err_msg=key)
            np.testing.assert_array_equal(got.trajectory[key], eager.trajectory[key])


def test_use_stopping_false_matches_jax():
    kw = dict(**WIN, tau=0.0, step_factor=1e-3, lambd=1000.0, iterations=4, blind=True,
              correlation=False, use_stopping=False, record=True)
    w = whiteness_weights(WIN["bottom"] - WIN["top"], WIN["right"] - WIN["left"])
    want = jrl._solve(*map(np.asarray, (IMAGE, U, PSF, w)), use_tv=False, **kw)
    got = trl._solve(*map(torch.from_numpy, (IMAGE, U, PSF)), w, **kw)
    with trl._eager_outer_loop():
        eager = trl._solve(*map(torch.from_numpy, (IMAGE, U, PSF)), w, **kw)
    assert trl.loop_log[-1]["outers"] == 4
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), atol=1e-6, rtol=0)
    assert got[4][:2].tolist() == [4.0, 0.0]
    for a, b in zip(got[:5], eager[:5]):
        assert torch.equal(a, b)
    for key in ("M_r", "Hu", "varu"):
        np.testing.assert_allclose(got[5][key].numpy(), np.asarray(want[5][key]), atol=1e-6,
                                   rtol=0)
        assert torch.equal(got[5][key], eager[5][key])
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


def test_eager_outer_loop_restores_the_route_on_exit():
    args, kw = _args(tau=1e9, iterations=2, lambd=1000.0, blind=False)
    assert trl._EAGER_LOOP is False
    trl.loop_log.clear()
    with trl._eager_outer_loop():
        assert trl._EAGER_LOOP is True
        trl.richardson_lucy_MM(*args, device="cpu", **kw)
        with trl._eager_outer_loop():  # nested: the outer block stays eager
            pass
        assert trl._EAGER_LOOP is True
    assert trl._EAGER_LOOP is False
    assert not trl.loop_log  # the Python loop logged nothing
    with pytest.raises(RuntimeError, match="inside"), trl._eager_outer_loop():
        raise RuntimeError("inside")
    assert trl._EAGER_LOOP is False
    trl.richardson_lucy_MM(*args, device="cpu", **kw)
    assert trl.loop_log[-1] == dict(route="host", outers=2, reads=2, capture_ms=None)
