"""The routing and argument marshalling of the DTAM search and alternation
wrappers (``stereo/wta_cuda.py``, ``stereo/dtam_cuda.py``), checked on the
CPU through a stand-in for the kernels' library that records each call:
the entry points launch ``kt_wta_sq`` and ``kt_dtam_run`` (the search on
spans of pixels, the primal step fused into it) and count them; the
private helpers of the designs they replaced (``kt_wta_sq_pixel``,
``kt_dtam_run_split``), which only the card checks call, pass the same
arguments and count nothing. The kernels themselves are held against the
replaced designs and the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import contextlib

import numpy as np
import pytest
import torch

from kangaroo_tpu_torch import _build, backend
from kangaroo_tpu_torch.apps import stereo
from kangaroo_tpu_torch.stereo import dtam_cuda, wta_cuda


class _Library:
    """Records the kernels' C entry calls by name; each returns ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __getattr__(self, name):
        if not name.startswith("kt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or self.rc


@pytest.fixture
def library(monkeypatch):
    """The wrappers on CPU tensors, launching into a recording stand-in."""
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(backend, "require_kernels", lambda t, op: None)
    monkeypatch.setattr(backend, "stream_handle", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(wta_cuda, "sq_launches", 0)
    monkeypatch.setattr(dtam_cuda, "launches", 0)
    return lib


def _counts():
    return dtam_cuda.launches, wta_cuda.sq_launches


def _sq_call(args):
    """A kt_wta_sq(_pixel) call's arguments by name (_build.SIGNATURES
    order)."""
    names = ("vol", "bf16", "last", "out", "D", "H", "W", "sd", "lam", "theta", "stream")
    assert len(args) == len(names) == len(_build.SIGNATURES["kt_wta_sq"])
    return dict(zip(names, args))


def _dtam_call(args):
    """A kt_dtam_run(_split) call's arguments by name (_build.SIGNATURES
    order)."""
    names = ("vol", "bf16", "g", "d", "a", "q", "thetas", "D", "H", "W", "sd", "lam", "sigma_q",
             "sigma_d", "huber_alpha", "iterations", "stream")
    assert len(args) == len(names) == len(_build.SIGNATURES["kt_dtam_run"])
    return dict(zip(names, args))


def _dtam_inputs(shape, dtype=torch.float32):
    D, H, W = shape
    vol = torch.zeros(shape, dtype=dtype)
    g, d, a = torch.ones(H, W), torch.zeros(H, W), torch.zeros(H, W)
    return vol, g, d, a, torch.zeros(H, W, 2)


def test_the_old_designs_share_the_argument_lists():
    assert _build.SIGNATURES["kt_wta_sq_pixel"] == _build.SIGNATURES["kt_wta_sq"]
    assert _build.SIGNATURES["kt_dtam_run_split"] == _build.SIGNATURES["kt_dtam_run"]


@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_search_launches_the_span_kernel(library, dtype, sd):
    vol = torch.zeros((6, 5, 9), dtype=dtype)
    last = torch.zeros(5, 9)
    out = wta_cuda.cost_vol_minimum_square_penalty_subpix(vol, last, 20.0, 0.25, sd)
    (name, args), = library.calls
    c = _sq_call(args)
    assert name == "kt_wta_sq" and out.shape == (5, 9) and out.dtype == torch.float32
    assert (c["vol"], c["last"], c["out"]) == (vol.data_ptr(), last.data_ptr(), out.data_ptr())
    assert (c["bf16"], c["D"], c["H"], c["W"], c["sd"]) == (int(dtype == torch.bfloat16), 6, 5,
                                                            9, sd)
    assert (c["lam"], c["theta"], c["stream"]) == (20.0, 0.25, 0)
    assert _counts() == (0, 1)


def test_search_takes_tensor_scalars(library):
    vol, last = torch.zeros(4, 3, 8), torch.zeros(3, 8)
    wta_cuda.cost_vol_minimum_square_penalty_subpix(vol, last, torch.tensor(2.5),
                                                    torch.tensor(0.5, dtype=torch.float64))
    c = _sq_call(library.calls[0][1])
    assert (c["lam"], c["theta"]) == (2.5, 0.5)
    assert all(isinstance(c[k], float) for k in ("lam", "theta"))


def test_search_pixel_design_takes_the_same_arguments(library):
    """``_square_penalty_pixel`` passes ``kt_wta_sq_pixel`` what the entry
    point passes ``kt_wta_sq`` (the output buffer aside), counting
    nothing."""
    offset = torch.zeros(1 + 7 * 4 * 10, dtype=torch.bfloat16)
    vol, last = offset[1:].view(7, 4, 10), torch.zeros(4, 10)
    new = wta_cuda.cost_vol_minimum_square_penalty_subpix(vol, last, 3.0, 1e-3, 1)
    old = wta_cuda._square_penalty_pixel(vol, last, 3.0, 1e-3, 1)
    (n_new, a_new), (n_old, a_old) = library.calls
    assert (n_new, n_old) == ("kt_wta_sq", "kt_wta_sq_pixel")
    c_new, c_old = _sq_call(a_new), _sq_call(a_old)
    assert c_new.pop("out") == new.data_ptr() and c_old.pop("out") == old.data_ptr()
    assert c_new == c_old and c_new["vol"] == vol.data_ptr()
    assert _counts() == (0, 1)


def test_search_checks_before_it_launches(library):
    vol = torch.zeros(4, 3, 8)
    with pytest.raises(ValueError, match="does not match"):
        wta_cuda.cost_vol_minimum_square_penalty_subpix(vol, torch.zeros(3, 7), 1.0, 1.0)
    with pytest.raises(ValueError, match="does not match"):
        wta_cuda._square_penalty_pixel(vol, torch.zeros(3, 7), 1.0, 1.0)
    with pytest.raises(TypeError):
        wta_cuda.cost_vol_minimum_square_penalty_subpix(vol.half(), torch.zeros(3, 8), 1.0, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        wta_cuda.cost_vol_minimum_square_penalty_subpix(vol.transpose(1, 2).contiguous()
                                                        .transpose(1, 2), torch.zeros(3, 8),
                                                        1.0, 1.0)
    assert library.calls == [] and _counts() == (0, 0)


@pytest.mark.parametrize("iterations", [1, 50])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dtam_run_launches_the_fused_alternation(library, dtype, iterations):
    vol, g, d, a, q = _dtam_inputs((8, 6, 12), dtype)
    q[..., 1] = 1.0
    out_d, out_a, out_q, theta = dtam_cuda.dtam_run(vol, g, d, a, q, 100.0, 1.0, 20.0, 0.7, 0.6,
                                                    0.002, 1e-3, iterations, sd=1)
    (name, args), = library.calls
    c = _dtam_call(args)
    assert name == "kt_dtam_run"
    assert (c["vol"], c["bf16"], c["g"]) == (vol.data_ptr(), int(dtype == torch.bfloat16),
                                             g.data_ptr())
    # d and a are copies updated in place; q goes in as its two planes
    assert (c["d"], c["a"]) == (out_d.data_ptr(), out_a.data_ptr())
    assert c["d"] != d.data_ptr() and c["a"] != a.data_ptr() and c["q"] != q.data_ptr()
    assert (c["D"], c["H"], c["W"], c["sd"], c["iterations"]) == (8, 6, 12, 1, iterations)
    assert c["lam"] == 20.0 and c["sigma_q"] == 0.7 and c["sigma_d"] == 0.6
    assert c["huber_alpha"] == 0.002 and c["stream"] == 0
    assert torch.equal(out_q, q)  # the stand-in leaves the planes as they came
    want = dtam_cuda.anneal(100.0, 1e-3, 1.0, iterations)
    assert float(theta) == float(want[-1])
    # one alternation call, `iterations` searches
    assert _counts() == (1, iterations)


def test_dtam_counts_add_up_over_calls(library):
    vol, g, d, a, q = _dtam_inputs((4, 3, 8))
    for its in (3, 5, 0, 2):
        dtam_cuda.dtam_run(vol, g, d, a, q, 1.0, 0.0, 1.0, 0.5, 0.5, 0.0, 0.0, its)
    assert [name for name, _ in library.calls] == ["kt_dtam_run"] * 4
    assert [_dtam_call(args)["iterations"] for _, args in library.calls] == [3, 5, 0, 2]
    # a call of 0 iterations launches nothing on the card and is not counted
    assert _counts() == (3, 10)


def test_dtam_zero_iterations_return_the_state(library):
    vol, g, d, a, q = _dtam_inputs((4, 3, 8))
    d.fill_(2.0)
    out_d, out_a, out_q, theta = dtam_cuda.dtam_run(vol, g, d, a, q, 7.0, 1.0, 1.0, 0.5, 0.5,
                                                    0.0, 1e-3, 0)
    assert torch.equal(out_d, d) and torch.equal(out_a, a) and torch.equal(out_q, q)
    assert float(theta) == 7.0 and _counts() == (0, 0)


def test_dtam_split_design_takes_the_same_arguments(library):
    """``_dtam_run_split`` passes ``kt_dtam_run_split`` what ``dtam_run``
    passes ``kt_dtam_run`` (its own copies of the state aside), with the
    same anneal, counting nothing."""
    vol, g, d, a, q = _dtam_inputs((5, 4, 6), torch.bfloat16)
    args = (vol, g, d, a, q, 50.0, 3.0, 20.0, 0.7, 0.7, 0.002, 1e-3, 4, -1)
    new = dtam_cuda.dtam_run(*args)
    old = dtam_cuda._dtam_run_split(*args)
    (n_new, a_new), (n_old, a_old) = library.calls
    assert (n_new, n_old) == ("kt_dtam_run", "kt_dtam_run_split")
    c_new, c_old = _dtam_call(a_new), _dtam_call(a_old)
    for key in ("d", "a", "q", "thetas"):
        c_new.pop(key), c_old.pop(key)
    assert c_new == c_old
    assert float(new[3]) == float(old[3])
    assert _counts() == (1, 4)


def test_dtam_thetas_reach_the_kernel(library, monkeypatch):
    """The per-iteration theta array (``anneal``) is what the C entry
    reads: the wrapper passes its host address."""
    seen = {}
    real = dtam_cuda.anneal

    def anneal(*a):
        seen["thetas"] = real(*a)
        return seen["thetas"]

    monkeypatch.setattr(dtam_cuda, "anneal", anneal)
    vol, g, d, a, q = _dtam_inputs((4, 3, 8))
    dtam_cuda.dtam_run(vol, g, d, a, q, 10.0, 2.0, 1.0, 0.5, 0.5, 0.0, 1e-2, 3)
    c = _dtam_call(library.calls[0][1])
    assert c["thetas"] == seen["thetas"].ctypes.data
    np.testing.assert_array_equal(seen["thetas"], real(10.0, 1e-2, 2.0, 3))


def test_dtam_step_and_solve_route_through_dtam_run(library):
    vol, g, d, a, q = _dtam_inputs((4, 3, 8))
    out = dtam_cuda.dtam_step(vol, g, d, a, q, 10.0, 6.0, 1.0, 0.5, 0.5, 0.0, 1e-3,
                              iterations=5, sd=1)
    assert float(out[4]) == 11.0
    dtam_cuda.dtam_solve(vol, g, d, 1.0, 10.0, 0.5, 0.5, 0.0, 1e-3, iterations=7)
    assert [(name, _dtam_call(args)["iterations"]) for name, args in library.calls] == [
        ("kt_dtam_run", 5), ("kt_dtam_run", 7)]
    assert _counts() == (2, 12)


def test_failed_launch_raises_and_counts_nothing(library):
    library.rc = 1
    vol, g, d, a, q = _dtam_inputs((4, 3, 8))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        dtam_cuda.dtam_run(vol, g, d, a, q, 1.0, 0.0, 1.0, 0.5, 0.5, 0.0, 0.0, 2)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        wta_cuda.cost_vol_minimum_square_penalty_subpix(vol, d, 1.0, 1.0)
    assert _counts() == (0, 0)


def test_cpu_tensors_take_the_plain_alternation(library):
    """On the CPU the app runs the plain loop and launches nothing."""
    D, H, W = 6, 5, 12
    rng = np.random.default_rng(0)
    vol = torch.from_numpy(rng.random((D, H, W), dtype=np.float32))
    g = torch.ones(H, W)
    d = torch.from_numpy(rng.uniform(0, D, (H, W)).astype(np.float32))
    got = stereo._iterate(vol, g, d, d, torch.zeros(H, W, 2), 10.0, 1.0, 2.0, 0.5, 0.5, 0.0,
                          1e-3, 3, -1)
    want = stereo.dtam_iterate_plain(vol, g, d, d, torch.zeros(H, W, 2), 10.0, 1.0, 2.0, 0.5,
                                     0.5, 0.0, 1e-3, 3)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert library.calls == [] and _counts() == (0, 0)
