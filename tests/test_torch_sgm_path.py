"""One SGM path direction at a time: ``stereo.sgm.aggregate_direction`` (the
plain version of ``csrc/sgm_path.cu``'s ``kt_sgm_path``) against the JAX
package's per-direction scans, and the routing and argument marshalling of
the kernel wrappers in ``stereo/sgm_cuda.py``, checked on the CPU through a
stand-in for the kernels' library that records each call.

Tolerances: 1e-5 on the disparity lattice against the JAX package (XLA on
the CPU may fuse differently); the directions summed in the plain order
equal the plain aggregate exactly (the same operations in the same order).
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kangaroo_tpu.stereo import sgm as jsgm
from kangaroo_tpu_torch import _build, backend
from kangaroo_tpu_torch.stereo import sgm_cuda
from kangaroo_tpu_torch.stereo import sgm as tsgm

# steps (sx, sy) in the plain version's sum order
STEPS = [(0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, 1), (1, -1), (-1, -1)]


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, dtype=np.float32), rng.random(shape[1:], dtype=np.float32))


def _lattice(sd, shape):
    d = np.arange(shape[0])[:, None, None]
    x = np.arange(shape[2])[None, None, :]
    return np.broadcast_to((d <= x) if sd < 0 else (x + d < shape[2]), shape)


def _jax_direction(vol, img, step, sd):
    """One direction through the JAX package's scans, as its
    ``semi_global_matching`` runs it: (D, H, W) in, (D, H, W) out."""
    D, H, W = vol.shape
    v = jnp.moveaxis(jnp.asarray(vol), 0, -1)  # (H, W, D)
    i = jnp.asarray(img)
    d = jnp.arange(D)[None, None, :]
    x = jnp.arange(W)[None, :, None]
    m = jnp.broadcast_to((d <= x) if sd < 0 else (x + d < W), (H, W, D))
    sx, sy = step
    if sx == 0:
        lr = jsgm._scan_direction(v, i, m, 0.01, 0.02, reverse=sy < 0)
    elif sy == 0:
        lr = jnp.swapaxes(jsgm._scan_direction(jnp.swapaxes(v, 0, 1), i.T, jnp.swapaxes(m, 0, 1),
                                               0.01, 0.02, reverse=sx < 0), 0, 1)
    else:
        flip = lambda a: (a[::-1] if sy < 0 else a)[:, ::-1] if sx < 0 else (
            a[::-1] if sy < 0 else a)
        lr = flip(jsgm._scan_diagonal(flip(v), flip(i), flip(m), 0.01, 0.02, dx=1))
    return np.asarray(jnp.moveaxis(lr, -1, 0))


@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("step", STEPS)
def test_direction_matches_jax_scan(step, sd):
    vol, img = _inputs(30, (16, 12, 40))
    got = tsgm.aggregate_direction(torch.from_numpy(vol), torch.from_numpy(img), step,
                                   0.01, 0.02, sd).numpy()
    m = _lattice(sd, vol.shape)
    np.testing.assert_allclose(got[m], _jax_direction(vol, img, step, sd)[m], atol=1e-5)
    assert np.all(got[~m] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sd", [-1, 1])
def test_directions_sum_to_the_aggregate(sd, dtype):
    vol, img = (torch.from_numpy(a) for a in _inputs(31, (24, 9, 30)))
    vol = vol.to(dtype)
    want = tsgm.semi_global_matching(vol, img, 0.01, 0.02, do_diagonal=True, sd=sd)
    got = torch.zeros(want.shape)
    for step in STEPS:
        got = got + tsgm.aggregate_direction(vol, img, step, 0.01, 0.02, sd)
    assert torch.equal(got, want)


def test_direction_adds_onto_acc_in_place():
    vol, img = (torch.from_numpy(a) for a in _inputs(32, (8, 7, 13)))
    acc = torch.rand(vol.shape, generator=torch.Generator().manual_seed(0))
    want = acc + tsgm.aggregate_direction(vol, img, (-1, 1))
    view = acc.clone()
    got = tsgm.aggregate_direction(vol, img, (-1, 1), acc=view)
    assert got is view and torch.equal(got, want)


def test_direction_checks_its_arguments():
    vol, img = (torch.from_numpy(a) for a in _inputs(33, (4, 5, 6)))
    for bad in ((0, 0), (2, 1), (1,)):
        with pytest.raises(ValueError, match="step"):
            tsgm.aggregate_direction(vol, img, bad)
    with pytest.raises(ValueError, match="sd"):
        tsgm.aggregate_direction(vol, img, (1, 0), sd=0)


# --- the wrappers' routing, through a stand-in library ---------------------


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
    for name in ("launches", "diagonal_launches", "segment_launches", "diag_segment_launches"):
        monkeypatch.setattr(sgm_cuda, name, 0)
    return lib


def _path_call(args):
    """A kt_sgm_path call's arguments by name (_build.SIGNATURES order)."""
    names = ("vol", "bf16", "vol_sd", "vol_sy", "img", "img_sy", "out", "out_sd", "out_sy",
             "D", "S", "N", "sx", "sy", "sd", "P1", "P2", "accumulate", "stream")
    assert len(args) == len(names) == len(_build.SIGNATURES["kt_sgm_path"])
    return dict(zip(names, args))


def _segment_call(args):
    """A kt_sgm_segment(_lines) call's arguments by name (_build.SIGNATURES
    order)."""
    names = ("vol", "bf16", "vol_sd", "vol_sy", "img", "img_sy", "out", "acc", "out_sd",
             "out_sy", "D", "S", "N", "sx", "sy", "sd", "xoff", "width", "seam", "P1", "P2",
             "cin_prev", "cin_best", "cin_img", "cin_has", "cout_prev", "cout_best", "stream")
    assert len(args) == len(names) == len(_build.SIGNATURES["kt_sgm_segment"])
    return dict(zip(names, args))


def _counts():
    return (sgm_cuda.launches, sgm_cuda.diagonal_launches, sgm_cuda.segment_launches,
            sgm_cuda.diag_segment_launches)


@pytest.mark.parametrize("do_diagonal", [False, True])
def test_whole_image_directions_launch_the_path_kernel(library, do_diagonal):
    vol = torch.zeros((8, 6, 10), dtype=torch.bfloat16)
    img = torch.zeros((6, 10))
    out = sgm_cuda.semi_global_matching(vol, img, 0.05, 0.1, do_diagonal=do_diagonal, sd=1)
    calls = [_path_call(a) for name, a in library.calls]
    assert [name for name, _ in library.calls] == ["kt_sgm_path"] * len(calls)
    assert [(c["sx"], c["sy"]) for c in calls] == STEPS[:8 if do_diagonal else 4]
    assert [c["accumulate"] for c in calls] == [0] + [1] * (len(calls) - 1)
    for c in calls:
        assert (c["vol"], c["bf16"], c["img"], c["out"]) == (vol.data_ptr(), 1, img.data_ptr(),
                                                           out.data_ptr())
        assert (c["vol_sd"], c["vol_sy"], c["img_sy"], c["out_sd"], c["out_sy"]) == (60, 10, 10,
                                                                                    60, 10)
        assert (c["D"], c["S"], c["N"], c["sd"]) == (8, 6, 10, 1)
        assert c["P1"] == pytest.approx(0.05) and c["P2"] == pytest.approx(0.1)
    assert _counts() == (4, 4 if do_diagonal else 0, 0, 0)


def test_row_shard_scan_runs_the_path_kernel_in_place(library):
    """A row shard's horizontal pair on views of wider arrays: the strides
    reach the kernel, and the output is the accumulator itself."""
    vol = torch.zeros((4, 12, 9))
    img = torch.zeros((12, 11))
    acc = torch.zeros((4, 5, 9 + 3))
    v, i, a = vol[:, 2:7], img[2:7, 1:10], acc[:, :, 3:]
    out = sgm_cuda.sgm_aggregate_scan(v, i, scan_is_x=True, acc=a)
    assert out is a
    calls = [_path_call(args) for _, args in library.calls]
    assert [(c["sx"], c["sy"], c["accumulate"]) for c in calls] == [(1, 0, 1), (-1, 0, 1)]
    for c in calls:
        assert c["vol"] == v.data_ptr() and c["img"] == i.data_ptr() and c["out"] == a.data_ptr()
        assert (c["vol_sd"], c["vol_sy"], c["img_sy"], c["out_sd"], c["out_sy"]) == (108, 9, 11,
                                                                                    60, 12)
        assert (c["D"], c["S"], c["N"]) == (4, 5, 9)
    assert _counts() == (2, 0, 0, 0)


def test_whole_column_scan_runs_the_path_kernel(library):
    vol, img = torch.zeros((4, 5, 9)), torch.zeros((5, 9))
    sgm_cuda.sgm_aggregate_scan(vol, img, do_reverse=False, mask_mode="right")
    (name, args), = library.calls
    c = _path_call(args)
    assert name == "kt_sgm_path" and (c["sx"], c["sy"], c["sd"], c["accumulate"]) == (0, 1, 1, 0)
    assert _counts() == (1, 0, 0, 0)


@pytest.mark.parametrize("kwargs", [dict(lane_offset=0), dict(width=12, lane_offset=3),
                                    dict(seam_period=5)])
def test_segment_scans_run_the_segment_kernel(library, kwargs):
    vol, img = torch.zeros((4, 10, 9)), torch.zeros((10, 9))
    sgm_cuda.sgm_aggregate_scan(vol, img, **kwargs)
    assert [name for name, _ in library.calls] == ["kt_sgm_segment"] * 2
    assert _counts() == (0, 0, 2, 0)


def test_seam_pass_splits_between_the_kernels(library):
    vol, img = torch.zeros((4, 10, 9)), torch.zeros((10, 9))
    sgm_cuda.semi_global_matching(vol, img, seam_period=5)
    assert [name for name, _ in library.calls] == ["kt_sgm_segment"] * 2 + ["kt_sgm_path"] * 2
    assert _counts() == (2, 0, 2, 0)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed", [True, False])
def test_row_segment_runs_the_segment_kernel(library, seed, reverse):
    """A column block's row segment (views of wider arrays) at its lattice
    offset, added in place onto ``acc``: one ``kt_sgm_segment`` call with
    the carry in (none on a seed) and out."""
    vol = torch.zeros((4, 10, 12), dtype=torch.bfloat16)[:, :, 2:11]
    img = torch.zeros((10, 12))[:, 2:11]
    acc = torch.zeros((4, 10, 9))
    carry = {} if seed else dict(carry_prev=torch.zeros(4, 9), carry_best=torch.zeros(9),
                                 last_img=torch.zeros(9))
    out, prev, best, last = sgm_cuda.sgm_aggregate_block(
        vol, img, 0.05, 0.1, "right", width=20, seed=seed, lane_offset=6, acc=acc,
        reverse=reverse, **carry)
    (name, args), = library.calls
    c = _segment_call(args)
    assert name == "kt_sgm_segment" and out is acc
    assert c["out"] == c["acc"] == acc.data_ptr() and (c["vol"], c["img"]) == (vol.data_ptr(),
                                                                               img.data_ptr())
    assert (c["vol_sd"], c["vol_sy"], c["img_sy"], c["out_sd"], c["out_sy"]) == (120, 12, 12,
                                                                                90, 9)
    assert (c["D"], c["S"], c["N"], c["sx"], c["sy"], c["sd"]) == (4, 10, 9, 0,
                                                                   -1 if reverse else 1, 1)
    assert (c["xoff"], c["width"], c["seam"]) == (6, 20, 0)
    assert (c["cout_prev"], c["cout_best"]) == (prev.data_ptr(), best.data_ptr())
    cin = (c["cin_prev"], c["cin_best"], c["cin_img"], c["cin_has"])
    assert cin == ((None,) * 4 if seed else (carry["carry_prev"].data_ptr(),
                                             carry["carry_best"].data_ptr(),
                                             carry["last_img"].data_ptr(), None))
    assert torch.equal(last, img[0 if reverse else -1])
    assert _counts() == (0, 0, 1, 0)


@pytest.mark.parametrize("dx", [1, -1])
def test_diagonal_segment_runs_the_segment_kernel(library, dx):
    vol, img = torch.zeros((4, 6, 9)), torch.zeros((6, 9))
    carry = (torch.zeros(4, 9), torch.zeros(9), torch.ones(9), torch.zeros(9))
    out, prev, best, _, has = sgm_cuda.sgm_aggregate_diag_block(vol, img, *carry, dx=dx,
                                                                width=8, reverse=True)
    (name, args), = library.calls
    c = _segment_call(args)
    assert name == "kt_sgm_segment"
    assert (c["out"], c["acc"]) == (out.data_ptr(), None)
    assert (c["sx"], c["sy"], c["sd"], c["xoff"], c["width"], c["seam"]) == (dx, -1, -1, 0, 8, 0)
    assert (c["cin_prev"], c["cin_best"], c["cin_img"], c["cin_has"]) == tuple(
        t.data_ptr() for t in (carry[0], carry[1], carry[3], carry[2]))
    assert (c["cout_prev"], c["cout_best"]) == (prev.data_ptr(), best.data_ptr())
    assert torch.equal(has, torch.ones(9))
    assert _counts() == (0, 0, 0, 1)


def test_lines_design_takes_the_segment_arguments(library):
    """Both segment entries have one argument list, and ``_launch_lines``
    passes ``kt_sgm_segment_lines`` what ``_launch`` passes
    ``kt_sgm_segment``, counting neither."""
    assert _build.SIGNATURES["kt_sgm_segment_lines"] == _build.SIGNATURES["kt_sgm_segment"]
    vol, img, out = torch.zeros((4, 6, 9)), torch.zeros((6, 9)), torch.zeros((4, 6, 9))
    cin = (torch.zeros(4, 9), torch.zeros(9), torch.zeros(9), torch.ones(9))
    cout = (torch.zeros(4, 9), torch.zeros(9))
    args = (vol, img, out, out, (1, 1), 1, 3, 20, 0, 0.05, 0.1, "sgm_segment", cin, cout)
    sgm_cuda._launch(*args)
    sgm_cuda._launch_lines(*args)
    (new, a_new), (old, a_old) = library.calls
    assert (new, old) == ("kt_sgm_segment", "kt_sgm_segment_lines") and a_new == a_old
    assert _counts() == (0, 0, 0, 0)


def test_direction_wrapper_launches_once(library):
    vol, img = torch.zeros((3, 4, 5)), torch.zeros((4, 5))
    acc = torch.zeros((3, 4, 5))
    assert sgm_cuda.aggregate_direction(vol, img, (-1, -1), sd=1, acc=acc) is acc
    (name, args), = library.calls
    c = _path_call(args)
    assert name == "kt_sgm_path" and (c["sx"], c["sy"], c["sd"], c["accumulate"]) == (-1, -1,
                                                                                       1, 1)
    assert _counts() == (0, 1, 0, 0)


def test_failed_launch_raises_and_counts_nothing(library):
    library.rc = 1
    vol, img = torch.zeros((3, 4, 5)), torch.zeros((4, 5))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        sgm_cuda.aggregate_direction(vol, img, (1, 0))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        sgm_cuda.semi_global_matching(vol, img)
    assert _counts() == (0, 0, 0, 0)


def test_direction_wrapper_refuses_cpu_tensors():
    vol, img = (torch.from_numpy(a) for a in _inputs(34, (4, 5, 6)))
    before = _counts()
    with pytest.raises(RuntimeError, match="sm_90"):
        sgm_cuda.aggregate_direction(vol, img, (0, 1))
    assert _counts() == before
