"""The utilities of kangaroo_tpu_torch against kangaroo_tpu's on the CPU:
sorting networks (``utils/sorting_network.py``), the NaN debug modes
(``utils/debug.py``), profiling (``utils/profiling.py``) and timing
(``utils/timing.py``).

Tolerances. Swap lists equal; sorted and median stacks equal, NaN at the
same places and +0 equal to -0 (as the median kernel's check has it:
min/max of a signed-zero pair may return either). The debug modes: each
case of the semantics table raises, or records the same message, in both
packages.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kangaroo_tpu.apps import stereo as jstereo
from kangaroo_tpu.apps import synthetic as jsyn
from kangaroo_tpu.utils import debug as jdebug
from kangaroo_tpu.utils import sorting_network as jsn
from kangaroo_tpu.utils import timing as jtiming
from kangaroo_tpu_torch.apps import stereo as tstereo
from kangaroo_tpu_torch.utils import debug as tdebug
from kangaroo_tpu_torch.utils import profiling as tprofiling
from kangaroo_tpu_torch.utils import sorting_network as tsn
from kangaroo_tpu_torch.utils import timing as ttiming

NAN, INF = float("nan"), float("inf")


@pytest.mark.parametrize("n", range(1, 26))
def test_swap_lists_match_jax(n):
    assert tsn.bitonic_swaps(n) == jsn.bitonic_swaps(n)
    assert tsn.median_swaps(n) == jsn.median_swaps(n)


@pytest.mark.parametrize("n", [1, 2, 5, 9, 12, 25])
def test_sort_and_median_of_stack_match_jax(n):
    rng = np.random.default_rng(n)
    stack = rng.normal(size=(n, 7, 6)).astype(np.float32)
    special = rng.random(stack.shape)
    stack[special < 0.06] = np.nan
    stack[(special >= 0.06) & (special < 0.1)] = np.inf
    stack[(special >= 0.1) & (special < 0.14)] = -np.inf
    stack[(special >= 0.14) & (special < 0.18)] = 0.0
    stack[(special >= 0.18) & (special < 0.22)] = -0.0
    want_sort = np.stack(jsn.sort_stack(jnp.asarray(stack)))
    want_median = np.asarray(jsn.median_of_stack(jnp.asarray(stack)))
    for values in (torch.from_numpy(stack), list(torch.from_numpy(stack))):
        got_sort = torch.stack(tsn.sort_stack(values)).numpy()
        got_median = tsn.median_of_stack(values).numpy()
        # assert_array_equal: NaN at the same places, +0 == -0
        np.testing.assert_array_equal(got_sort, want_sort)
        np.testing.assert_array_equal(got_median, want_median)


def _both(make):
    """``make(xp, asarray)`` on both packages: (JAX result, port result)."""
    j = make(jnp, lambda a: jnp.asarray(np.asarray(a, np.float32)))
    t = make(torch, lambda a: torch.from_numpy(np.asarray(a, np.float32)))
    return j, t


# (name, fn(xp, x, y): x = [1, nan], y = [-1, 1], raises under debug_mode)
DEBUG_CASES = [
    ("propagated nan", lambda xp, x, y: x + 1, True),
    ("log(-1)", lambda xp, x, y: xp.log(y), True),
    ("0/0", lambda xp, x, y: (y + 1) / (y + 1), True),
    ("slice of a nan", lambda xp, x, y: x[1:], True),
    ("1/0 is inf", lambda xp, x, y: 1.0 / (y + 1), False),
    ("overflow is inf", lambda xp, x, y: xp.exp(y * 1000.0), False),
    ("masked sentinel", lambda xp, x, y: xp.where(xp.isfinite(x), x, 0.0), False),
]


@pytest.mark.parametrize("name,fn,raises", DEBUG_CASES, ids=[c[0] for c in DEBUG_CASES])
def test_debug_mode_table_matches_jax(name, fn, raises):
    for xp, mod, asarray in ((jnp, jdebug, jnp.asarray), (torch, tdebug, torch.tensor)):
        x, y = asarray([1.0, NAN]), asarray([-1.0, 1.0])
        if raises:
            with pytest.raises(FloatingPointError, match="invalid value \\(nan\\) encountered"):
                with mod.debug_mode():
                    fn(xp, x, y)
        else:
            with mod.debug_mode():
                out = fn(xp, x, y)
            assert not np.isnan(np.asarray(out)).any()


def test_debug_mode_call_style_and_restore():
    for xp, mod in ((jnp, jdebug), (torch, tdebug)):
        y = xp.asarray([-1.0, 1.0])
        mod.debug_mode(True)
        try:
            with pytest.raises(FloatingPointError):
                xp.log(y)
            with mod.debug_mode():
                pass
            with pytest.raises(FloatingPointError):  # the scope restored the switch
                xp.log(y)
        finally:
            mod.debug_mode(False)
        assert np.isnan(np.asarray(xp.log(y))[0])
        with mod.debug_mode():
            pass
        assert np.isnan(np.asarray(xp.log(y))[0])  # and restored it off


def test_debug_mode_raises_on_a_stereo_frame():
    """NaN is data: a normal stereo frame (census WTA) writes NaN for its
    invalid pixels, so it raises under debug_mode in both packages (the
    contract). The JAX package checks when it compiles: its caches are
    cleared first."""
    jl, jr, _ = jsyn.stereo_pair(48, 24, 8, seed=0)
    tl, tr = torch.tensor(np.asarray(jl)), torch.tensor(np.asarray(jr))
    cfg = {"max_disp": 8}
    assert np.isnan(tstereo.stereo_pipeline(tl, tr, tstereo.StereoConfig(**cfg),
                                            use_dtam=False).numpy()).any()
    jax.clear_caches()
    with pytest.raises(FloatingPointError):
        with jdebug.debug_mode():
            jstereo.stereo_pipeline(jl, jr, jstereo.StereoConfig(**cfg), use_dtam=False)
    with pytest.raises(FloatingPointError):
        with tdebug.debug_mode():
            tstereo.stereo_pipeline(tl, tr, tstereo.StereoConfig(**cfg), use_dtam=False)


def _assert_then(mod, xp):
    def f(v):
        mod.assert_all_finite(v, "depth")
        return xp.log(v)
    return f


def _log_then_assert(mod, xp):
    def f(v):
        out = xp.log(v)
        mod.assert_all_finite(v, "depth")
        return out
    return f


ASSERT_MSG = "depth contains non-finite values (`check` failed)"
# (name, fn(mod, xp) -> function of v, the input v, what err.get() gives)
CHECKED_CASES = [
    ("nan generated", lambda mod, xp: xp.log, [-1.0, 1.0], "nan generated by primitive: log."),
    ("nan propagated", lambda mod, xp: lambda v: v + 1, [1.0, NAN],
     "nan generated by primitive: add."),
    ("division by zero", lambda mod, xp: lambda v: 1.0 / v, [2.0, 0.0], "division by zero"),
    ("0/0", lambda mod, xp: lambda v: v / v, [0.0, 1.0], "division by zero"),
    ("overflow", lambda mod, xp: lambda v: v * v, [1e30, 1.0], None),
    ("exp overflow", lambda mod, xp: xp.exp, [1e3, 1.0], None),
    ("finite", lambda mod, xp: lambda v: v * 2, [1.0, 2.0], None),
    ("assert first", _assert_then, [-1.0, INF], ASSERT_MSG),
    # checkify's order: a failed assertion wins over a NaN made before it
    ("log first", _log_then_assert, [-1.0, INF], ASSERT_MSG),
    ("log first, assertion holds", _log_then_assert, [-1.0, 1.0],
     "nan generated by primitive: log."),
    ("log then div", lambda mod, xp: lambda v: xp.log(v) + 1.0 / (v + 1), [-1.0, INF],
     "nan generated by primitive: log."),
    ("div then log", lambda mod, xp: lambda v: 1.0 / (v + 1) + xp.log(v), [-1.0, INF],
     "division by zero"),
]


@pytest.mark.parametrize("name,make,v,want", CHECKED_CASES, ids=[c[0] for c in CHECKED_CASES])
def test_checked_table_matches_jax(name, make, v, want):
    (jerr, _), (terr, _) = _both(
        lambda xp, asarray: (jdebug if xp is jnp else tdebug).checked(
            make(jdebug if xp is jnp else tdebug, xp))(asarray(v)))
    assert jerr.get() == terr.get() == want
    if want is None:
        terr.throw()
    else:
        for err in (jerr, terr):
            with pytest.raises(ValueError, match="nan|division|depth"):
                err.throw()


def test_assert_all_finite_outside_checked_raises():
    for mod, asarray in ((jdebug, jnp.asarray), (tdebug, torch.tensor)):
        mod.assert_all_finite(asarray([1.0, 2.0]), "fine")
        with pytest.raises(ValueError, match="bad contains non-finite values"):
            mod.assert_all_finite(asarray([1.0, NAN]), "bad")


def test_profiling_trace_and_memory_report(tmp_path):
    with tprofiling.trace(str(tmp_path / "trace")) as logdir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert "aten::mm" in (tmp_path / "trace" / files[0]).read_text()
    report = tprofiling.device_memory_report()
    assert isinstance(report, str) and report


def test_timer_and_time_fn_stats():
    x = torch.ones(256, 256)
    stats = ttiming.time_fn_stats(lambda a: a @ a, x, iters=4, k=3)
    want = jtiming.time_fn_stats(lambda a: a @ a, jnp.ones((8, 8)), iters=2, k=3)
    assert list(stats) == list(want) == ["median", "min", "max"]
    assert 0 < stats["min"] <= stats["median"] <= stats["max"]
    timer = ttiming.Timer("mm")
    for _ in range(3):
        timer.start()
        out = {"a": x @ x, "b": [x + 1, (x * 2,)]}
        assert timer.stop(out) > 0
    assert len(timer.times) == 3 and 0 < timer.min <= timer.avg <= timer.max
    timer.print_summary()
